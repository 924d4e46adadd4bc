"""rescue_roofline.keygen: the Rescue kernel's share (%) of its roofline:
the least time the card could hash a batch (``yardstick.rescue_hash_bound_s``:
the squarings, products and additions Rescue-Prime of the configuration
needs at the least, each product or squaring at the multiply-adds a
Montgomery product or squaring of 4-word elements needs, at the published
integer peak) over the kernel's mean device time a launch in the trace."""

from starkbench import yardstick
from starkbench.reference.checks import rescue_of


def read(run):
    kernel_s = sum(ns for name, ns in run.device_ns.items() if "rescue" in name.lower()) / 1e9
    if not run.requests or kernel_s <= 0:
        return None
    r = rescue_of(run.config)
    bound = yardstick.rescue_hash_bound_s(run.traffic["batch"], r.m, r.N, r.alpha, r.alpha_inv)
    return bound * run.requests / kernel_s * 100
