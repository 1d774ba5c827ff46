"""Host-side witness inputs: Tendermint types, the fixture/RPC fetcher and
the synthetic test chain.

Copies of ``tendermintx_tpu/inputs`` (plain Python, no jax), so that the
port and ``chip_smoke.py`` stand without the JAX package. Keep them in step
with the reference: ``tests/test_torch_composite.py`` checks that both give
the same skip inputs.
"""
