"""The launch convention of the port's CUDA libraries (``ops/nvcc.py``), on
the CPU.

* Each module's ``SIGNATURES`` names every ``extern "C" int sv_*`` entry of
  its ``.cu`` file, with the same arity and the same pointer, int and u64
  kinds; every entry that launches work ends in ``int device, void*
  stream`` and places itself on that card, and no other entry takes a
  stream.
* ``nvcc.load`` declares every entry when it loads a library, raises for
  an entry the library lacks, and keeps no library that its module's
  check refuses; each module's ``build`` loads its own table and check,
  and the checks refuse another layout.
* ``nvcc.launch`` passes the card's index and its current stream last,
  records the C call alone as its span, raises with the entry's name on a
  CUDA error, and records nothing while the recorder is off.
"""

import ctypes
import ctypes.util
import itertools
import re
from pathlib import Path

import pytest
import torch

from swiftvideo_tpu_torch.core import spans
from swiftvideo_tpu_torch.ops import audio, frame, motion, nvcc

MODULES = {"frame": frame, "motion": motion, "audio": audio}
_KINDS = {ctypes.c_int: "int", ctypes.c_uint64: "u64",
          ctypes.c_ulonglong: "u64", ctypes.c_void_p: "ptr"}


@pytest.fixture(autouse=True)
def recorder_off():
    spans.stop()
    yield
    spans.stop()


def _entries(source: Path):
    """{name: ([(C type, parameter name)], body)} of every ``extern "C"
    int sv_*`` entry of ``source``."""
    text = source.read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (sv_\w+)\(([^)]*)\)\s*\{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        params = []
        for p in filter(None, (p.strip() for p in m.group(2).split(","))):
            ctype, name = re.match(r"(.*?)\s*(\w+)$", " ".join(p.split())).groups()
            params.append((ctype, name))
        out[m.group(1)] = (params, text[m.end():i])
    return out


def _c_kind(ctype: str) -> str:
    if "*" in ctype:
        return "ptr"
    return {"int": "int", "unsigned long long": "u64"}[ctype]


def _ctypes_kind(t) -> str:
    if isinstance(t, type) and issubclass(t, ctypes._Pointer):
        return "ptr"
    return _KINDS[t]


def _launches(body: str) -> bool:
    """Whether an entry's body launches work: a kernel launch, or the
    file's own launch helper."""
    return "<<<" in body or re.search(r"\blaunch\(", body) is not None


@pytest.mark.parametrize("name", MODULES)
def test_signatures_mirror_the_kernel_source(name):
    mod = MODULES[name]
    entries = _entries(mod.SOURCE)
    assert entries and set(mod.SIGNATURES) == set(entries)
    launching = 0
    for entry, (params, body) in entries.items():
        restype, argtypes = mod.SIGNATURES[entry]
        assert restype is ctypes.c_int, entry
        assert ([_ctypes_kind(t) for t in argtypes]
                == [_c_kind(c) for c, _ in params]), entry
        if _launches(body):
            launching += 1
            assert params[-2:] == [("int", "device"), ("void*", "stream")], entry
            assert ("cudaSetDevice(device)" in body
                    or "DeviceScope scope(device)" in body), entry
        else:
            assert all(p != "stream" for _c, p in params), entry
    assert launching >= 1


def test_the_device_scope_restores_the_current_device():
    """The motion entries' ``DeviceScope`` sets and restores the current
    device as the frame and audio entries do inline."""
    text = motion.SOURCE.read_text()
    body = re.search(r"struct DeviceScope \{(.*?)\n\};", text, re.S).group(1)
    assert "cudaGetDevice(&current)" in body
    assert "if (current != device) cudaSetDevice(device);" in body
    assert "~DeviceScope()" in body
    assert "if (current != device) cudaSetDevice(current);" in body


@pytest.fixture
def libc(monkeypatch, tmp_path):
    """``nvcc.load`` on the C library in place of a built source: no nvcc
    runs (each build is recorded) and nothing is kept between tests."""
    builds = []
    monkeypatch.setattr(nvcc, "_libs", {})
    monkeypatch.setattr(nvcc, "build_all", builds.append)
    monkeypatch.setattr(nvcc, "library_path", lambda source: Path(
        ctypes.util.find_library("c") or "libc.so.6"))
    return tmp_path / "libc.cu", builds


def test_load_declares_every_entry_once(libc):
    source, builds = libc
    table = {"strlen": (ctypes.c_size_t, [ctypes.c_char_p]),
             "abs": (ctypes.c_int, [ctypes.c_int])}
    lib = nvcc.load(source, table)
    assert lib.strlen.restype is ctypes.c_size_t
    assert lib.strlen.argtypes == [ctypes.c_char_p]
    assert lib.abs.argtypes == [ctypes.c_int]
    assert lib.strlen(b"abcd") == 4 and lib.abs(-7) == 7
    assert nvcc.load(source, table) is lib and builds == [[source]]


def test_load_raises_for_an_entry_the_library_lacks(libc):
    source, _builds = libc
    with pytest.raises(AttributeError, match="sv_no_such_entry"):
        nvcc.load(source, {"sv_no_such_entry": (ctypes.c_int, [])})
    assert source not in nvcc._libs


def test_load_keeps_no_library_its_check_refuses(libc):
    source, builds = libc
    seen = []

    def refuse(lib):
        seen.append(lib)
        raise RuntimeError("another layout")

    for _ in range(2):
        with pytest.raises(RuntimeError, match="another layout"):
            nvcc.load(source, {"abs": (ctypes.c_int, [ctypes.c_int])}, refuse)
    assert len(seen) == 2 and source not in nvcc._libs and len(builds) == 2
    assert seen[0].abs.argtypes == [ctypes.c_int]


@pytest.mark.parametrize("name", MODULES)
def test_build_loads_its_table_and_check(monkeypatch, name):
    mod = MODULES[name]
    calls = []
    monkeypatch.setattr(nvcc, "load", lambda *args: calls.append(args) or "lib")
    assert mod.build() == "lib"
    checks = {"frame": (frame._check_layout,),
              "motion": (motion._check_geometry,), "audio": ()}
    assert calls == [(mod.SOURCE, mod.SIGNATURES) + checks[name]]


class _FrameLib:
    def __init__(self, size, capacity):
        self.size, self.capacity = size, capacity

    def sv_frame_params_size(self):
        return self.size

    def sv_frame_capacity(self):
        return self.capacity


class _MotionLib:
    def __init__(self, geometry):
        self.geometry = geometry

    def sv_motion_geometry(self, buf, n):
        for i, v in enumerate(self.geometry[:n]):
            buf[i] = v
        return len(self.geometry)


@pytest.mark.parametrize("case", ["frame", "frame capacity", "motion",
                                  "motion order", "motion length"])
def test_layout_checks_refuse_another_layout(case):
    size, geometry = frame._PARAMS.itemsize, list(motion.GEOMETRY.values())
    good, bad, check = {
        "frame": (_FrameLib(size, frame.CAPACITY),
                  _FrameLib(size + 8, frame.CAPACITY), frame._check_layout),
        "frame capacity": (_FrameLib(size, frame.CAPACITY),
                           _FrameLib(size, frame.CAPACITY + 1),
                           frame._check_layout),
        "motion": (_MotionLib(geometry), _MotionLib([geometry[0] + 1]
                                                    + geometry[1:]),
                   motion._check_geometry),
        "motion order": (_MotionLib(geometry), _MotionLib(geometry[::-1]),
                         motion._check_geometry),
        "motion length": (_MotionLib(geometry), _MotionLib(geometry + [1]),
                          motion._check_geometry),
    }[case]
    check(good)
    with pytest.raises(RuntimeError, match=r"\.cu"):
        check(bad)


@pytest.fixture
def clock(monkeypatch):
    """One clock for the recorder, the stream lookup and the entry (0, 1,
    2, ... a reading), and the events each reading marks."""
    ticks = itertools.count()
    events = []

    def read(what):
        t = next(ticks)
        events.append((what, t))
        return t

    monkeypatch.setattr(spans, "perf_counter_ns", lambda: read("span"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: (read("stream"), 0x5eed + index)[1],
                        raising=False)
    return read, events


class _Entry:
    """A C entry's stand-in: records its arguments and returns ``err``."""

    __name__ = "sv_fake_launch"

    def __init__(self, read, err=0):
        self.read, self.err, self.calls = read, err, []

    def __call__(self, *args):
        self.read("call")
        self.calls.append(args)
        return self.err


@pytest.mark.parametrize("dev,index", [(torch.device("cuda", 0), 0),
                                       (torch.device("cuda", 1), 1),
                                       (torch.device("cuda"), 3)],
                         ids=["cuda:0", "cuda:1", "cuda (current)"])
def test_launch_passes_the_card_and_its_stream_last(clock, dev, index):
    read, _events = clock
    entry = _Entry(read)
    nvcc.launch(entry, dev, 7, None, 2**40)
    assert entry.calls == [(7, None, 2**40, index, 0x5eed + index)]


def test_launch_span_covers_the_call_alone(clock):
    read, events = clock
    entry = _Entry(read)
    spans.start()
    nvcc.launch(entry, torch.device("cuda", 0), 1, span="x.launch")
    rec = spans.stop()
    assert [rec.names[k] for k in rec.name] == ["x.launch"]
    assert [what for what, _t in events] == ["stream", "span", "call", "span"]
    assert rec.start[0] == events[1][1] and rec.end[0] == events[3][1]


def test_launch_raises_with_the_entrys_name(clock):
    read, events = clock
    entry = _Entry(read, err=719)
    spans.start()
    with pytest.raises(RuntimeError,
                       match="sv_fake_launch launch failed: CUDA error 719"):
        nvcc.launch(entry, torch.device("cuda", 0), span="x.launch")
    rec = spans.stop()
    # the span ended before the raise
    assert len(rec) == 1 and rec.end[0] > rec.start[0]
    assert len(entry.calls) == 1


@pytest.mark.parametrize("span", [None, "x.launch"])
def test_launch_records_nothing_while_the_recorder_is_off(clock, monkeypatch,
                                                          span):
    def refuse(*_a, **_k):
        raise AssertionError("a launch reached the recorder while it was off")

    read, events = clock
    monkeypatch.setattr(spans, "begin", refuse)
    monkeypatch.setattr(spans, "end", refuse)
    entry = _Entry(read)
    nvcc.launch(entry, torch.device("cuda", 0), 5, span=span)
    assert entry.calls == [(5, 0, 0x5eed)]
    assert [what for what, _t in events] == ["stream", "call"]
    rec = spans.stop()
    assert len(rec) == 0 and rec.counters == {}


def test_launch_without_a_span_records_none_while_on(clock):
    read, _events = clock
    spans.start()
    nvcc.launch(_Entry(read), torch.device("cuda", 0))
    rec = spans.stop()
    assert len(rec) == 0

