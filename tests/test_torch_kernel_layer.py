"""The port's kernel layer, `tpu3drec_torch/_nvcc.py`: one route rule and
one launch path for every CUDA kernel wrapper, checked on the CPU.

- every public wrapper routes through `_nvcc.route`: a tensor on a device
  that is neither the CPU nor CUDA raises `ValueError` naming its kernel;
- `_nvcc.launch` passes the current stream last, raises `RuntimeError`
  with the kernel's name and the CUDA error on a non-zero return and
  counts nothing then, and counts `<name>.launches` once on success;
- `_nvcc.aligned16` copies only a tensor whose data is off 16 bytes;
- the `ori_desc` kernel's module loads without SIFT's, so imports run one
  way: `ops/sift.py` -> `ops/pallas_sample.py` -> `_nvcc.py`.
"""

import ctypes
import contextlib
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch_threads import torch_threads  # noqa: E402,F401  (autouse)

from tpu3drec_torch import _nvcc
from tpu3drec_torch.ops import attention, conv, pallas_match, pallas_sample
from tpu3drec_torch.ops import pallas_sgm, sift
from tpu3drec_torch.utils.profiling import counters

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


WRAPPERS = {
    "ori_desc": lambda: pallas_sample.ori_desc(
        _meta((2, 96, 128), torch.bfloat16), _meta((2, 96, 128),
                                                   torch.bfloat16),
        _meta((5, 4), torch.int32), 96, 6),
    "knn2": lambda: pallas_match.knn2_raw(
        _meta((1, 4, 128), torch.int8), _meta((1, 5, 128), torch.int8),
        _meta((1, 5), torch.int32), _meta((1, 5), torch.bool)),
    "sgm": lambda: pallas_sgm.sgm_aggregate_batch(
        _meta((1, 4, 3, 5), torch.float32)),
    "dog_extrema": lambda: sift.dog_extrema(
        _meta((1, sift.N_LAYERS + 3, 16, 16), torch.float32), 0.04),
    "masked_attention": lambda: attention.masked_attention(
        _meta((1, 3, 2, 8), torch.float32), _meta((1, 4, 2, 8),
                                                  torch.float32),
        _meta((1, 4, 2, 8), torch.float32), _meta((1, 4), torch.bool),
        1.0),
    "conv_nhwc": lambda: conv.conv2d_nhwc(
        _meta((1, 6, 8, 4), torch.float32), _meta((8, 4, 3, 3),
                                                  torch.float32),
        _meta((8,), torch.float32), True, True),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_reject_other_devices(name):
    with pytest.raises(ValueError, match=rf"^{name}: unsupported device meta"):
        WRAPPERS[name]()


@pytest.mark.parametrize("device,want", [
    ("cpu", "plain"), (torch.device("cpu"), "plain"),
    ("cuda", "kernel"), (torch.device("cuda", 1), "kernel"),
    ("meta", ValueError), ("mps", ValueError),
])
def test_route(device, want):
    if isinstance(want, str):
        assert _nvcc.route("k", device) == want
    else:
        with pytest.raises(want, match="^k: unsupported device"):
            _nvcc.route("k", device)


@pytest.fixture
def stub_card(monkeypatch):
    """`_nvcc`'s device context, stream lookup and entry points replaced,
    so a launch runs on the CPU: `calls` records each entry's symbol,
    argtypes, restype and arguments; `rc[symbol]` is what it returns."""
    calls, rc = [], {}

    def entry(name, symbol, argtypes, restype=ctypes.c_int):
        def fn(*args):
            calls.append((symbol, argtypes, restype, args))
            return rc[symbol]
        return fn

    monkeypatch.setattr(_nvcc, "entry", entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=4242))
    return SimpleNamespace(calls=calls, rc=rc)


@pytest.mark.parametrize("err", [0, 1, 700])
def test_launch(stub_card, err):
    name = f"stub_kernel_{err}"
    stub_card.rc["stub_launch"] = err
    types = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    before = counters().get(f"{name}.launches", 0)
    args = (name, "stub_launch", types, torch.device("cuda", 0), 123, 7)
    if err:
        with pytest.raises(RuntimeError,
                           match=rf"^{name} kernel launch failed: CUDA "
                                 rf"error {err}$"):
            _nvcc.launch(*args)
    else:
        assert _nvcc.launch(*args) is None
    # the stream's handle goes last, after the caller's arguments
    assert stub_card.calls == [("stub_launch", types, ctypes.c_int,
                                (123, 7, 4242))]
    assert counters().get(f"{name}.launches", 0) == before + (err == 0)


def test_launch_and_query_take_cuda_tensors_only(stub_card):
    for call in (_nvcc.launch, _nvcc.query):
        with pytest.raises(ValueError, match="^stub: the kernel takes CUDA"):
            call("stub", "stub_launch", (), torch.device("cpu"))
    assert stub_card.calls == []


@pytest.mark.parametrize("ret", [0, 96, -2])
def test_query(stub_card, ret):
    stub_card.rc["stub_work_ints"] = ret
    args = ("stub", "stub_work_ints", (ctypes.c_int,) * 2,
            torch.device("cuda", 0), 3, 4)
    if ret < 0:
        with pytest.raises(RuntimeError, match=r"^stub: device query failed: "
                                               r"CUDA error 2$"):
            _nvcc.query(*args)
    else:
        assert _nvcc.query(*args) == ret
    # a query returns a count, takes no stream and launches nothing
    assert stub_card.calls == [("stub_work_ints", (ctypes.c_int,) * 2,
                                ctypes.c_longlong, (3, 4))]


def test_aligned16_copies_only_off_boundary_data():
    base = torch.arange(64, dtype=torch.int8)
    assert _nvcc.aligned16(base) is base
    view = base[1:33]
    copy = _nvcc.aligned16(view)
    assert copy is not view and copy.data_ptr() % 16 == 0
    assert torch.equal(copy, view)


def test_ori_desc_module_loads_without_sift():
    """Imported alone (the packages' `__init__`s, which import the whole
    port, left out), `ops/pallas_sample.py` loads the kernel layer and the
    profiling registry, not `ops/sift.py`."""
    code = (
        "import sys, types\n"
        "for name in ('tpu3drec_torch', 'tpu3drec_torch.ops',\n"
        "             'tpu3drec_torch.utils'):\n"
        "    mod = types.ModuleType(name)\n"
        "    mod.__path__ = [sys.argv[1] + '/' + name.replace('.', '/')]\n"
        "    sys.modules[name] = mod\n"
        "import tpu3drec_torch.ops.pallas_sample\n"
        "print(' '.join(sorted(m for m in sys.modules\n"
        "                      if m.startswith('tpu3drec_torch.'))))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "tpu3drec_torch.ops.sift" not in out
    assert set(out) == {"tpu3drec_torch._nvcc", "tpu3drec_torch.ops",
                        "tpu3drec_torch.ops.pallas_sample",
                        "tpu3drec_torch.utils",
                        "tpu3drec_torch.utils.profiling"}
