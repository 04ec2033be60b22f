"""The episode kernel's SVMPC update: Silverman's bandwidth, the DISCO
weights and delta and the Stein step (its clock's `silverman` +
`disco_weights` + `disco_delta` + `stein_forward`), in us per episode step
(`phases`)."""

from perfbench.phases import group_us


def read(ctx):
    return group_us(ctx, "svmpc")
