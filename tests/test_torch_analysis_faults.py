"""The two port faults the invariant engine found, each held here:

* CST-EXC-002: the SIGTERM handler's thread targeted
  ``CaptionServer.shutdown`` itself, so a failing drain killed the
  thread silently with the listener half down.  The thread now targets
  ``_signal_shutdown``, which logs ``"SIGTERM shutdown failed"``, as the
  JAX package's server does (its
  ``tests/test_observability.py::test_sigterm_shutdown_wrapper_logs_not_raises``).
* CST-CFG-002 on ``model.param_dtype``: the port read the knob nowhere,
  so ``--model.param_dtype bfloat16`` silently built float32 leaves.
  The knob is now read: the three values the port once refused build
  the reference's leaves (bfloat16, float16, and float32 with a warning
  for float64), held leaf by leaf against the JAX ``model.init`` tree
  in ``tests/test_torch_param_dtype.py``; a value the reference cannot
  build is refused, naming the knob.
"""

import ast
import inspect
import logging
import textwrap

import pytest

from cst_captioning_torch import config as tcfg
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.serving.server import CaptionServer


def test_sigterm_shutdown_wrapper_logs_not_raises(caplog):
    srv = CaptionServer.__new__(CaptionServer)

    def broken_shutdown(drain=True):
        raise RuntimeError("teardown exploded")

    srv.shutdown = broken_shutdown
    with caplog.at_level(logging.ERROR,
                         logger="cst_captioning_torch.serving"):
        srv._signal_shutdown()     # must not raise
    assert any("SIGTERM shutdown failed" in r.message
               for r in caplog.records)


def test_sigterm_thread_targets_the_wrapper():
    """The handler installed by serve_forever starts its thread on
    ``_signal_shutdown``, never on ``shutdown``."""
    tree = ast.parse(textwrap.dedent(
        inspect.getsource(CaptionServer.serve_forever)))
    targets = [
        ast.unparse(kw.value)
        for node in ast.walk(tree) if isinstance(node, ast.Call)
        for kw in node.keywords if kw.arg == "target"
    ]
    assert targets == ["self._signal_shutdown"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float64"])
def test_param_dtype_other_than_float32_is_refused(dtype):
    """The name is kept on purpose (the test's id predates the wiring);
    what it checks is the opposite of it: bfloat16, float16 and float64
    are NOT refused but build their leaves (float64 as float32, with a
    warning), and only a name the reference does not accept ("int8")
    is refused."""
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = 40
    cfg.model.param_dtype = dtype
    if dtype == "float64":
        with pytest.warns(UserWarning, match="model.param_dtype"):
            model = model_from_config(cfg, device="cpu")
    else:
        model = model_from_config(cfg, device="cpu")
    want = "float32" if dtype == "float64" else dtype
    assert {str(p.dtype) for p in model.parameters()} == {f"torch.{want}"}
    cfg.model.param_dtype = "int8"
    with pytest.raises(ValueError, match="model.param_dtype"):
        model_from_config(cfg, device="cpu")


def test_param_dtype_float32_builds_float32_leaves():
    cfg = tcfg.get_preset("synthetic_smoke")
    cfg.model.vocab_size = 40
    assert cfg.model.param_dtype == "float32"
    model = model_from_config(cfg, device="cpu")
    assert {str(p.dtype) for p in model.parameters()} == {"torch.float32"}
