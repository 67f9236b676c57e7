"""control_iterations.train: the mean PDHG iterations of a control step
(``AllocResult.stats["total_iterations"]``, from the result the step
returned) over the control steps of the window's untraced part."""


def read(record):
    steps = record.counters.get("control_steps", 0)
    if not steps:
        return None
    return record.counters["control_iterations"] / steps
