"""The share of the card's bf16 peak that the untraced window's completed
work reached: the frozen semantic operations of its passes (the
configuration's counts) over its seconds times 989 TFLOP/s, in percent."""

from portbench import yardstick


def read(run):
    flops = len(run.passes) * yardstick.pass_flops(run.cell)
    return 100.0 * flops / (run.window_s * yardstick.PEAK_BF16_FLOPS)
