"""A kernel's share of its roofline, and the whole step's share of the peak."""

from portbench import roofline

# the kernels' names in the device trace
K1 = "flash_fwd_t_bf16_kernel"
K3 = "flash_bwd_dkv_bf16_kernel<true>"


def roofline_pct(ctx, pattern: str, bound):
    """The least time of one call at the cell's batch over the mean device
    time of the calls in the trace (%); None where none ran."""
    tr = ctx["trace"]
    times = tr.kernel_times(pattern) if tr is not None else []
    if not times:
        return None
    cell = ctx["cell"]
    return 100.0 * bound(cell.config, cell.traffic["batch"]) / (sum(times) / len(times))


def mfu_pct(ctx, flops_per_unit: float, units: int):
    """Model FLOPs of the work done in the traced sub-window over its wall
    and the bf16 peak (%)."""
    tr = ctx["trace"]
    if tr is None or not units:
        return None
    return 100.0 * flops_per_unit * units / tr.window_s / roofline.PEAK_FLOPS
