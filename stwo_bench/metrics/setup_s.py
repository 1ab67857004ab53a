"""setup_s: seconds from the run's start to the window's: loading, the
seeded inputs, the warm-up and, in a checkout's first run, the builds."""


def read(record):
    return record["setup_s"]
