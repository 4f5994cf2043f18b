"""The readers of the program's spans (``readback_ms``, ``epilogue_ms``,
``prep_idle_pct``) on hand-built traced-run records: the union across
cards, the device records matched by the correlation ids of the runtime
calls made inside a span, idle gaps cut to the spans, and no number where
the program made no such span."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.cell import reader  # noqa: E402

READERS = ("readback_ms", "epilogue_ms", "prep_idle_pct")


def _rec(device, host, annotations, units=2, window=(0.0, 1000.0)):
    """A traced run's record as ``run.py`` hands it to the readers; times
    in us."""
    return {"trace": {"window_us": window, "device": device, "host": host,
                      "annotations": annotations},
            "units": units}


def _call(ts, corr, name="cudaMemcpyAsync"):
    return (ts, ts + 1.0, name, "cuda_runtime", corr)


def test_readback_is_the_union_of_its_copies_across_cards():
    # two frames' readback spans; copies 1-3 were enqueued inside them,
    # copy 4 and kernel 5 outside or not a copy
    host = [_call(10, 1), _call(12, 2), _call(300, 3), _call(500, 4),
            _call(305, 5, "cudaLaunchKernel")]
    device = {
        0: [("Memcpy DtoH", "gpu_memcpy", 20, 120, 1),
            ("Memcpy DtoH", "gpu_memcpy", 310, 350, 3),
            ("Memcpy DtoH", "gpu_memcpy", 510, 600, 4)],
        1: [("Memcpy DtoH", "gpu_memcpy", 100, 150, 2),
            ("elementwise", "kernel", 306, 900, 5)],
    }
    spans = {"gamer.readback": [(5, 200), (290, 320)]}
    got = reader("readback_ms").read(_rec(device, host, spans))
    # [20, 150] across both cards, then [310, 350]: 170 us over 2 frames
    assert got == pytest.approx(170e-3 / 2)


def test_epilogue_sums_the_records_of_its_calls_over_cards():
    host = [_call(10, 1, "cudaLaunchKernel"), _call(15, 2, "cudaLaunchKernel"),
            _call(40, 3, "cudaLaunchKernel"), _call(60, 4, "cudaMemcpyAsync"),
            _call(70, 5, "cudaLaunchKernel"),
            (12, 14, "aten::add", "cpu_op", None)]
    device = {
        0: [("pool", "kernel", 100, 130, 1), ("post", "kernel", 120, 160, 2),
            ("march", "kernel", 200, 900, 3), ("stack", "gpu_memcpy", 920,
                                               925, 4)],
        1: [("post", "kernel", 990, 1010, 5)],
    }
    # the third call (corr 3) lies between the two epilogue spans
    spans = {"gamer.epilogue": [(5, 20), (55, 80)],
             "gamer.march": [(35, 45)]}
    got = reader("epilogue_ms").read(_rec(device, host, spans, units=1))
    # 30 + 40 (overlap counted on each record) + 5 + 10 (cut at the window)
    assert got == pytest.approx(85e-3)


def test_prep_idle_is_the_idle_gaps_inside_prep_spans_mean_over_cards():
    device = {
        0: [("march", "kernel", 0, 400, 1), ("march", "kernel", 500, 1000,
                                             2)],
        1: [("march", "kernel", 0, 300, 3), ("march", "kernel", 450, 1000,
                                             4)],
    }
    # prep from 350 to 480 on the host: card 0 idle inside it 400-480,
    # card 1 idle 350-450; the second span overlaps no gap
    spans = {"gamer.prep": [(350, 480), (600, 700)]}
    got = reader("prep_idle_pct").read(_rec(device, [], spans))
    assert got == pytest.approx(100.0 * (80 + 100) / 2 / 1000)


def test_prep_idle_counts_overlapping_spans_once():
    device = {0: [("march", "kernel", 0, 100, 1)]}
    spans = {"gamer.prep": [(200, 400), (300, 500)]}
    got = reader("prep_idle_pct").read(_rec(device, [], spans))
    assert got == pytest.approx(100.0 * 300 / 1000)


@pytest.mark.parametrize("name", READERS)
def test_no_number_without_the_span(name):
    """The parent program makes no span: each reader is left out."""
    host = [_call(10, 1)]
    device = {0: [("Memcpy DtoH", "gpu_memcpy", 20, 120, 1)]}
    spans = {"host_prep": [(0, 50)], "frame": [(0, 900)]}
    assert reader(name).read(_rec(device, host, spans)) is None
