"""output_tok_s: tokens served by every batch of the window over the sum of
those batches' walls (host clock; each wall ends in the blocking pull of
the batch's outputs). Batch loops only."""


def read(run):
    w = run.window
    if "walls" not in w:
        return None
    return sum(w["tokens"]) / sum(w["walls"])
