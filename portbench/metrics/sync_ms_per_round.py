"""Device milliseconds a round of the local-SGD sync: the loop's own CUDA
event clock (``LocalSGDResult.phase_s``) of the pseudo-gradients with
their compression and of the outer update, over the timed call's
rounds."""


def read(run):
    p = run.phase_s
    if not p or not run.rounds or "pseudograd" not in p:
        return None
    return 1e3 * (p["pseudograd"] + p.get("outer", 0.0)) / run.rounds
