# corpus-rules: configflow
"""Knob reads in the port's idioms.  A section handed to a constructor
binds the __init__'s parameter (through super().__init__ too) and is
held on the object; its knobs are read later through self; knob names
reach a getattr through a for-loop over a literal tuple.  Every
declared knob but the seeded dead one is read only in these shapes,
so a resolver gap would fire CST-CFG-002 here; one typo'd read through
the held section fires CST-CFG-001."""


class Optimizer:
    def __init__(self, params, cfg_train, steps_per_epoch):
        self.cfg_train = cfg_train            # the section, held
        self.clip = cfg_train.grad_clip       # read through the param
        self.params = params

    def rate(self, step):
        return self.cfg_train.learning_rate   # held read

    def moments(self):
        b1 = self.cfg_train.beta1             # held read
        b2 = self.cfg_train.beta_two  # expect: CST-CFG-001
        return b1, b2


class MeshOptimizer(Optimizer):
    def __init__(self, params, cfg_train, steps_per_epoch):
        super().__init__(params, cfg_train, steps_per_epoch)

    def decay(self):
        return self.cfg_train.undocumented_rate   # inherited holder


def make_optimizer(cfg, params):
    return MeshOptimizer(params, cfg.train, 10)


def decode_gates(cfg):
    m = cfg.model

    def gate(flag):
        return getattr(m, flag, False)

    out = {}
    for what, flag in (("sample", "use_pallas_sampler"),
                       ("beam", "use_pallas_beam")):
        out[what] = gate(flag)
    return out
