"""The share of the card's bf16 peak that the untraced window's completed
work reached: the frozen semantic operations of its passes (the
architecture's pass_flops on the configuration's counts) over its seconds
times 989 TFLOP/s, in percent."""

from portbench import yardstick


def read(run):
    flops = len(run.passes) * run.cell.arch.pass_flops(run.cell)
    return 100.0 * flops / (run.window_s * yardstick.PEAK_BF16_FLOPS)
