"""mfu: percent of the card's peak for the configuration's precision
that the model's FLOPs (portbench/work.py) reach over the unprofiled part
of the window."""


def read(r):
    if not r["on_device"] or not r["units_per_s"]:
        return None
    return 100.0 * r["model_flops"] * r["units_per_s"] / r["peak_ops_s"]
