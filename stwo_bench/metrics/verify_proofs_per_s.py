"""verify_proofs_per_s: every proof whose verdicts reached the host in the
window, over the window's seconds (the window closes with its last call)."""


def read(record):
    if record["kind"] != "verify":
        return None
    return record["proofs"] / record["window_s"]
