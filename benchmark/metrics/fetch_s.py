"""fetch_s: seconds an update spends in the inputs layer
(``inputs/fetcher.py``), reading the fixtures and assembling the witness
inputs: the spans around ``get_skip_inputs`` / ``get_step_inputs``, summed
over the window, over the updates answered in it."""

SPANS = {
    "fetch": [
        "tendermintx_tpu_torch.inputs.fetcher:InputDataFetcher.get_skip_inputs",
        "tendermintx_tpu_torch.inputs.fetcher:InputDataFetcher.get_step_inputs",
    ],
}


def read(run):
    return run.per_update("fetch")
