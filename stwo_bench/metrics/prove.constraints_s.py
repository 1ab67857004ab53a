"""prove.constraints_s: seconds a proof in its "interaction columns
generated" and "composition coefficients computed" stages (the interaction
and composition domain kernels, their interpolations, and the host work
under the spans prove.interaction and prove.composition), timed by the
benchmark's progress callback after a synchronize().  Nothing where a traced
proof lacks either stage: a renamed stage leaves the metric out instead of
reading 0."""

STAGES = ("interaction columns generated", "composition coefficients computed")


def read(record):
    if record["kind"] != "prove" or not record.get("stages"):
        return None
    total = 0.0
    for proof in record["stages"]:
        seconds = dict(proof)
        if any(msg not in seconds for msg in STAGES):
            return None
        total += sum(seconds[msg] for msg in STAGES)
    return total / len(record["stages"])
