"""Every kernel launch goes through ``kernels._build.launch``, which makes
the tensor's own device current around the C call and takes that
device's stream: a ``<<<>>>`` launch runs on the current device, so a
tensor on ``cuda:1`` launched from device 0's context would be refused.
Checked here without a card: a stand-in for ``torch.cuda.device``
records what the helper entered, and an AST scan finds no C entry point
called anywhere else."""

import ast
import contextlib
import os

import pytest
import torch

from c3poa_tpu_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "c3poa_tpu_torch")


class _FakeTensor:
    def __init__(self, device):
        self.device = torch.device(device)


class _FakeLib:
    def __init__(self, rc, log):
        self.rc, self.log = rc, log

    def c3t_probe(self, *args):
        self.log.append(("call", args))
        return self.rc

    def c3t_error_string(self, rc):
        return b"refused"


def _patched(monkeypatch, rc=0):
    log, current = [], []

    @contextlib.contextmanager
    def device(dev):
        current.append(dev)
        log.append(("enter", dev))
        try:
            yield
        finally:
            current.pop()
            log.append(("exit", dev))

    def stream_of(t):
        log.append(("stream", t.device, tuple(current)))
        return 4242

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "stream_of", stream_of)
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(rc, log))
    return log


@pytest.mark.parametrize("dev", ["cuda:0", "cuda:1", "cuda:3"])
def test_launch_enters_the_tensor_device(monkeypatch, dev):
    log = _patched(monkeypatch)
    _build.reset_counts()
    _build.launch("adapters", "c3t_probe", "probe_cuda", _FakeTensor(dev),
                  7, None, 9)
    d = torch.device(dev)
    assert log == [("enter", d), ("stream", d, (d,)),
                   ("call", (7, None, 9, 4242)), ("exit", d)]
    assert _build.launch_counts() == {"probe_cuda": 1}


def test_launch_raises_on_a_refused_launch(monkeypatch):
    _patched(monkeypatch, rc=1)
    with pytest.raises(RuntimeError, match="probe_cuda: CUDA error 1"):
        _build.launch("adapters", "c3t_probe", "probe_cuda",
                      _FakeTensor("cuda:1"), 1)


def _port_files():
    out = []
    for d, _dirs, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def test_no_entry_point_is_called_outside_the_helper():
    """No module touches a ``c3t_*`` entry point itself (``_build`` reads
    the error string and sets the signatures); each one in
    ``_build.SIGNATURES`` is named by some wrapper's ``_build.launch``
    call, as its second argument."""
    launched = set()
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr.startswith("c3t_"):
                assert rel.endswith(os.path.join("kernels", "_build.py")) \
                    and node.attr == "c3t_error_string", \
                    f"{rel}:{node.lineno} calls {node.attr}"
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "launch" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "_build":
                entry = node.args[1]
                assert isinstance(entry, ast.Constant), rel
                launched.add(entry.value)
    wanted = {fn for fns in _build.SIGNATURES.values() for fn in fns}
    assert launched == wanted
