"""verify_s: seconds an update spends in the port's host verifier before
the service answers (``verify_skip_composite`` / ``verify_step_composite``
over ``stark/verifier.py``, and ``stark/recursion.py`` for a wrapped
proof): the span around the call."""

SPANS = {
    "verify": [
        "tendermintx_tpu_torch.circuits.composite:verify_skip_composite",
        "tendermintx_tpu_torch.circuits.composite:verify_step_composite",
    ],
}


def read(run):
    return run.per_update("verify")
