"""The share of the program's episode-kernel launches whose MPF update
took the register loop rather than the shared-memory walk: 100 x reg /
(reg + smem) over the run, from the counters of the wrapper that the
runner's sweep adapter names (`sweep.wrapper.mpf_reg_launches` /
`.mpf_smem_launches`). None where the program has no such counters or
made no launch."""


def read(ctx):
    adapter = getattr(getattr(ctx.runner, "sweep", None), "sweep_fn", None)
    wrapper = getattr(adapter, "wrapper", None)
    reg = getattr(wrapper, "mpf_reg_launches", None)
    smem = getattr(wrapper, "mpf_smem_launches", None)
    if reg is None or smem is None or reg + smem == 0:
        return None
    return 100.0 * reg / (reg + smem)
