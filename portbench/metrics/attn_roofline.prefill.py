"""attn_roofline.prefill: causal attention's operation count over the
forwards that ran it in the Hopper flash kernel, over the summed device
time of the kernels named below, over the card's bf16 peak (attention is
bound by operations), in percent.  A forward runs the kernel where its
length passes the configuration's ``attn_chunk``; where the trace holds
another number of launches than one a layer of those forwards, or none,
nothing is read."""

from portbench.counts import flops, peaks

KERNELS = ("fa_wgmma_kernel", "fa_bf16_kernel")


def _is_flash(name):
    return any(k in name for k in KERNELS)


def read(record):
    chunk = record.port.get("attn_chunk", 0)
    runs = [it for it in record.items if it["L"] > chunk]
    layers = sum(1 for k in flops.layer_kinds(record.port) if k == "attn")
    launches = record.count_ops(_is_flash)
    if not runs or not layers or launches != layers * len(runs):
        return None
    seconds = record.device_time_s(_is_flash)
    work = sum(flops.attention_flops(record.port, it["B"], it["L"]) for it in runs)
    return 100.0 * work / seconds / peaks.BF16_FLOPS
