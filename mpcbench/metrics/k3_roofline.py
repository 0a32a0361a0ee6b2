"""K3's share of its roofline over both launches of a tick (the linearization's
step with sensitivities over B N rows, the plant's over B rows)."""


def read(tr):
    return tr.roofline_pct("k3")
