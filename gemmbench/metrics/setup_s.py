"""Set-up time: process start to the first timed call, on the host clock.  It holds the
imports, the card's start, the library build on a checkout's first run, the weights and
operands made on the card, and one warm call of every shape the cell runs."""
KIND = "end_to_end"
UNIT = "s"


def read(rec):
    return rec.setup_s
