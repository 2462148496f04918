"""K1's least time (the configuration's counted operations and bytes at the
cell's batch, against the H100's peaks) over K1's device time a launch."""

from benchmark.harness import roofline
from benchmark.harness.trace import bucket_of


def read(run):
    tr = run["trace"]
    ks = [k for k in tr.kernels if bucket_of(k.name) == "step_whole_kernel"] if tr else []
    if not ks:
        return None
    c = roofline.step_counts(run["cfg"])
    bound, _ = roofline.bound_ms(c["step_ops"] * run["batch"], c["step_bytes"] * run["batch"])
    per_launch = sum(k.end - k.start for k in ks) / 1e3 / len(ks)
    return 100.0 * bound / per_launch
