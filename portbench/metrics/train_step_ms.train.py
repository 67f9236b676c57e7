"""train_step_ms.train: the mean host wall of the benchmark's span around
the training step (``make_train_step``'s step, ending in the loss on the
host) over the iterations of the window's untraced part, in milliseconds:
the data plane's part of an iteration, steadier than the rate, which also
holds the host-bound controller."""


def read(record):
    spans = record.spans.get("train_step")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
