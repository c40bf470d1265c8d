"""The model FLOPs of the window's jobs (each epoch's train rows three
forwards' worth, its eval rows one, the postprocess forward over every node),
counted from the configuration's widths, over the window's time at the
card's f32 peak (TF32 is off on the port's path), in percent."""


def read(run):
    if run.kind != "train" or not run.flops or run.peaks is None:
        return None
    return 100.0 * run.flops / (run.window_s * run.peaks["f32_flops_per_s"])
