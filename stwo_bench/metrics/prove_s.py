"""prove_s: the window's seconds over the proofs it completed (the window
closes with its last proof)."""


def read(record):
    if record["kind"] != "prove":
        return None
    return record["window_s"] / record["units"]
