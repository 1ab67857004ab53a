"""prove.commit_s: seconds a proof in its Merkle tree stages, the stages
that end with a tree's "committed" message (and the streamed path's base
coefficients), timed by the benchmark's progress callback after a
synchronize().  Nothing where a traced proof has no tree stage: a renamed
stage leaves the metric out instead of reading 0."""


def _tree_stage(msg: str) -> bool:
    return (msg.startswith("tree") and msg.endswith("committed")) or msg.startswith("base coefficients")


def read(record):
    if record["kind"] != "prove" or not record.get("stages"):
        return None
    if any(not any(_tree_stage(msg) for msg, _ in proof) for proof in record["stages"]):
        return None
    total = sum(s for proof in record["stages"] for msg, s in proof if _tree_stage(msg))
    return total / len(record["stages"])
