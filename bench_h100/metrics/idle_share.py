"""Per cent of the untraced loop's time in which no operation ran on the
device: one minus the device's busy seconds (the union of its operations'
intervals in the traced stretch) over the untraced stretch's seconds, both
stretches of the same number of groups. The traced stretch's own seconds
hold the tracing's cost; its busy seconds do not."""


def read(trace, run):
    return 100.0 * (1.0 - trace.busy_s() / run["untraced_s"])
