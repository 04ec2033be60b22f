"""The episode kernel's MPF update: its bandwidth and its Stein loop (its
clock's `mpf_bandwidth` + `mpf_loop`), in us per episode step
(`phases`)."""

from perfbench.phases import group_us


def read(ctx):
    return group_us(ctx, "mpf")
