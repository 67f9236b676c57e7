"""mfu.prefill: the model FLOPs (``counts.flops.prefill_flops`` of every
forward's shape) of the untraced part of the window over that part's wall
over the card's bf16 peak, in percent."""

from portbench.counts import flops, peaks


def read(record):
    if not record.host_items or record.host_window_s <= 0:
        return None
    work = sum(flops.prefill_flops(record.port, it["B"], it["L"]) for it in record.host_items)
    return 100.0 * work / record.host_window_s / peaks.BF16_FLOPS
