"""stark_prove_s: seconds an update spends in the STARK prover
(``stark/batch.py::prove_batch`` over ``stark/prover.py`` and
``stark/fri.py``) for its composite batch: the span around the call
``circuits/composite.py`` makes, closed after the card has finished. A
wrap's own batch, where a request asks for one, is not in it."""

SPANS = {"stark_prove": ["tendermintx_tpu_torch.circuits.composite:prove_batch"]}


def read(run):
    return run.per_update("stark_prove")
