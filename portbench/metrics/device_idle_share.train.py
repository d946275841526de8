"""Percent of the traced section in which no kernel, copy or fill ran on the card."""


def read(r):
    return r.idle_pct()
