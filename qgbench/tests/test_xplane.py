"""The trace reduction: on made-up events, and on small traces recorded
on H100s with qgbench/tests/record_trace.py."""

import json
import pathlib

import pytest

from qgbench import xplane

DATA = pathlib.Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("name, hlo_op, cls", [
    ("void regular_fft<2048u, EPT<16u>, 4u>", "fft.8.0", "fft"),
    ("void vector_fft<2048u, EPT<16u>, 2u>", "command_buffer", "fft"),
    ("void scal_kernel_val<float2, float2>(cublasScalParamsVal)", "fft.9.0",
     "fft"),
    ("ncclDevKernel_AllToAll_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "all-to-all.1", "collective"),
    ("MemcpyD2H", "copy", "transfer"),
    ("MemcpyH2D", "", "transfer"),
    ("MemcpyD2D", "copy.14", "other"),
    ("loop_add_subtract_fusion", "command_buffer", "other"),
])
def test_classify(name, hlo_op, cls):
    assert xplane.classify(name, hlo_op) == cls


def made_up_trace():
    # Window: trace_start at 100 ns to the end of the last diagnostics
    # span at 1100 ns. Two devices.
    spans = [("trace_start", 100, 100), ("step", 150, 160),
             ("snapshot", 600, 800), ("diagnostics", 900, 1100)]
    dev0 = [(50, 200, "fusion", "other"),          # clipped to 100-200
            (180, 400, "regular_fft", "fft"),      # overlaps the first
            (650, 700, "MemcpyD2H", "transfer"),
            (1000, 1300, "fusion", "other")]       # clipped to 1000-1100
    dev1 = [(100, 1100, "ncclKernel", "collective")]
    return {"devices": {"/device:GPU:0": dev0, "/device:GPU:1": dev1},
            "spans": spans}


def test_summarize_made_up_trace():
    s = xplane.summarize(made_up_trace())
    assert s["window_s"] == pytest.approx(1000e-9)
    d0 = s["devices"]["/device:GPU:0"]
    # Busy: union of [100, 400], [650, 700], [1000, 1100].
    assert d0["busy_s"] == pytest.approx(450e-9)
    assert d0["classes"] == pytest.approx(
        {"other": 200e-9, "fft": 220e-9, "transfer": 50e-9})
    # Idle gaps [400, 650] (mid 525: no span), [700, 1000] (mid 850:
    # no span... 850 is outside snapshot and diagnostics).
    assert d0["idle"] == pytest.approx({"other": 550e-9})
    assert d0["busy_s"] + sum(d0["idle"].values()) == pytest.approx(
        s["window_s"])
    assert s["devices"]["/device:GPU:1"]["busy_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx((450e-9 + 1000e-9) / 2)


def test_idle_gap_goes_to_the_host_span_it_falls_in():
    trace = made_up_trace()
    trace["spans"][2] = ("snapshot", 400, 900)
    d0 = xplane.summarize(trace)["devices"]["/device:GPU:0"]
    assert d0["idle"] == pytest.approx({"snapshot": 550e-9})


def test_breakdown_lists_at_most_ten():
    trace = made_up_trace()
    trace["devices"]["/device:GPU:0"] += [
        (200 + i, 201 + i, f"k{i}", "other") for i in range(20)]
    b = xplane.breakdown(xplane.summarize(trace))
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    times = [t for _, t in b["device_ops"]]
    assert times == sorted(times, reverse=True)


RECORDED = sorted(p.name[:-len(".xplane.pb")] for p in DATA.glob("*.xplane.pb"))


@pytest.mark.parametrize("name", RECORDED)
def test_recorded_h100_trace(name):
    trace = xplane.load(str(DATA / f"{name}.xplane.pb"))
    s = xplane.summarize(trace)
    expected = json.loads((DATA / f"{name}.json").read_text())
    assert s["window_s"] == pytest.approx(expected["window_s"], rel=1e-12)
    assert s["busy_s"] == pytest.approx(expected["busy_s"], rel=1e-12)
    assert s["classes"] == pytest.approx(expected["classes"], rel=1e-12)
    for plane, d in s["devices"].items():
        assert plane.startswith("/device:GPU:")
        assert 0 < d["busy_s"] <= s["window_s"]
        assert d["busy_s"] + sum(d["idle"].values()) == pytest.approx(
            s["window_s"])
        assert d["classes"]["fft"] > 0 and d["classes"]["other"] > 0
        assert set(d["idle"]) <= {"other", "step", "snapshot",
                                  "diagnostics", "trace_start"}
    n = len(s["devices"])
    if n > 1:
        assert all(d["classes"].get("collective", 0) > 0
                   for d in s["devices"].values())
    else:
        assert "collective" not in s["classes"]


def test_both_recorded_traces_are_there():
    assert len(RECORDED) == 2, RECORDED


def test_only_the_cells_cards_count():
    path = str(DATA / "pod-1024.xplane.pb")
    every = xplane.summarize(xplane.load(path))
    one = xplane.summarize(xplane.load(path, planes={"/device:GPU:0"}))
    assert list(one["devices"]) == ["/device:GPU:0"]
    assert one["busy_s"] == pytest.approx(
        every["devices"]["/device:GPU:0"]["busy_s"])
    assert one["window_s"] == every["window_s"]
