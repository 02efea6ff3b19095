"""Set-up: process start to the first timed unit of work (loading, the
kernels' build on a checkout's first run, the weights made on the card,
warm-up), on the host clock."""


def read(record):
    return record["setup_s"]
