# corpus-rules: donation
"""Twin of the reference corpus's donation_bad.py in the port's idioms
(line for line): an update step registered update_step=True that
rebinds a parameter instead of writing it in place, a kernel load site
with no registry entry, and an AOT build site missing from the AOT
registry.  (The test injects the update step's registry entry.)"""

from cst_captioning_torch.ops import _build


def make_bad_update_step(model):
    def train_step(params, grads):
        for k, p in params.items():
            g = grads[k]
            # registered update step (injected by the test) REBINDING p
            p = p - 0.1 * g  # expect: CST-DON-001
    return train_step


def make_unregistered(model):
    def mystery(x):
        # a kernel library loaded at a site no registry entry names
        return _build.load("mystery")  # expect: CST-DON-002
    return mystery


def make_unregistered_aot(names, digests):
    # an ahead-of-time build with no AOT_SITE_REGISTRY entry
    return _build.build(names)  # expect: CST-DON-004
