"""service_overhead_s: seconds an update spends in the service layer
(``runtime/service.py``) outside the prover call: queueing, HTTP, JSON of
the proof and the client's polling. The traced run's ``update_s`` less
the mean span of the prover the service calls (the benchmark hands it a
``prover=`` that calls ``default_prover`` unchanged)."""


def read(run):
    prover = run.per_update("prover")
    if prover is None or run.update_s is None:
        return None
    return run.update_s - prover
