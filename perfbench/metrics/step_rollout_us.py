"""The episode kernel's noise, parameter draws and rollouts (its clock's
`noise` + `draws` + `rollouts`), in us per episode step (`phases`)."""

from perfbench.phases import group_us


def read(ctx):
    return group_us(ctx, "rollout")
