"""prove.upload_s: seconds a proof in its "trace uploaded (...)" stage (the
host AIR columns and their upload, spans prove.air and prove.upload), timed
by the benchmark's progress callback after a synchronize().  Nothing where
a traced proof has no such stage: a renamed stage leaves the metric out
instead of reading 0."""

STAGE = "trace uploaded"


def read(record):
    if record["kind"] != "prove" or not record.get("stages"):
        return None
    total = 0.0
    for proof in record["stages"]:
        found = [s for msg, s in proof if msg.startswith(STAGE)]
        if not found:
            return None
        total += sum(found)
    return total / len(record["stages"])
