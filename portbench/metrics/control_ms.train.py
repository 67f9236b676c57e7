"""control_ms.train: the mean host wall of the benchmark's span around
``PowerController.step``, ending in the allocation on the host, over the
control steps of the window's untraced part, in milliseconds."""


def read(record):
    spans = record.spans.get("control")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
