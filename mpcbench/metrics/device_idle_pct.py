"""The device's idle share over the traced segment: one minus the union of
device-operation intervals over the segment's host seconds."""


def read(tr):
    return tr.idle_pct()
