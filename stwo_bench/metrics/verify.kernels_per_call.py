"""verify.kernels_per_call: the CUDA kernels of the traced window, eager and
hand-written (copies and fills apart), over its verifier calls."""


def read(record):
    trace = record["trace"]
    if record["kind"] != "verify" or trace is None:
        return None
    return len(trace.kernels) / record["calls"]
