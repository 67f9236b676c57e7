"""mfu.train: the model FLOPs (``counts.flops.train_flops`` of every
step's batch) of the untraced part of the window over the summed walls of
its training steps (the benchmark's ``train_step`` spans, which leave the
controller's steps out) over the card's bf16 peak, in percent."""

from portbench.counts import flops, peaks


def read(record):
    walls = record.spans.get("train_step")
    if not record.host_items or not walls:
        return None
    work = sum(flops.train_flops(record.port, it["B"], it["L"]) for it in record.host_items)
    return 100.0 * work / sum(walls) / peaks.BF16_FLOPS
