"""prove.fri_s: seconds a proof from "FRI first-layer quotients computed" to
"FRI layers committed" (the FRI folds, their trees and the host channel),
timed by the benchmark's progress callback after a synchronize().  Nothing
where a traced proof lacks either message: a renamed stage leaves the
metric out instead of reading 0."""

START, END = "FRI first-layer quotients computed", "FRI layers committed"


def read(record):
    if record["kind"] != "prove" or not record.get("stages"):
        return None
    total = 0.0
    for proof in record["stages"]:
        msgs = [msg for msg, _ in proof]
        if START not in msgs:
            return None
        first = msgs.index(START) + 1
        last = next((k for k in range(first, len(msgs)) if msgs[k].startswith(END)), None)
        if last is None:
            return None
        total += sum(s for _, s in proof[first:last + 1])
    return total / len(record["stages"])
