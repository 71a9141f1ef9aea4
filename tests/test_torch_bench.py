"""The port's GPU bench (``vilgod_tpu_torch.tools.bench``) at its smoke
scale on the CPU: one JSON line with bench.py's fields (but
``vs_baseline``), ``delta_ap_max`` null and the device; and its stage
budget's attribution of device work to the stage spans."""
import json
import re

import pytest
import torch

from vilgod_tpu_torch.tools import bench

FIELDS = {"metric", "value", "unit", "vehicle_ap", "ped_ap", "cyc_ap",
          "quality_ok", "delta_ap_max", "platform", "stage_ms_per_frame",
          "stage_sum_ms_per_frame", "wall_ms_per_frame", "device"}
STAGES = {"mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections", "track_clusters",
          "classification", "fit_bounding_boxes_simple", "propagate_labels",
          "evaluate_sequence"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_smoke_prints_one_json_line(capsys):
    assert bench.main(["--scale", "smoke"]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == FIELDS
    assert line["metric"] == "e2e_frames_per_sec" and line["value"] > 0
    assert line["platform"] == "cpu" and line["device"] == "cpu"
    assert line["delta_ap_max"] is None
    assert "parity_oracle" in captured.err
    rows = line["stage_ms_per_frame"]
    assert set(rows) == STAGES | {"other_device", "host_setup_and_gaps"}
    assert min(rows.values()) >= 0
    assert rows["spatial_clustering"] > 0 and rows["filter_detections"] > 0
    # the rows split the untraced warm wall of the budget's sequence, or
    # exceed it where the traced device time does (as bench.py's do)
    warm = float(re.search(r"one warm seq; wall=([0-9.]+)",
                           captured.err).group(1))
    if rows["host_setup_and_gaps"] > 0:
        assert line["stage_sum_ms_per_frame"] == pytest.approx(warm, abs=0.1)
    else:
        assert line["stage_sum_ms_per_frame"] >= warm - 0.1
    assert sum(rows.values()) == pytest.approx(
        line["stage_sum_ms_per_frame"], abs=0.1)
    assert line["quality_ok"] and line["vehicle_ap"] >= 0.2


class _Event:
    """A raw profiler event's accessors; times in ns."""

    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, f"DeviceType.{device}", start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


@pytest.mark.parametrize("cuda", [True, False])
def test_stage_device_seconds_attributes_work_to_spans(cuda):
    """Work goes to the stage span holding its start, else to
    ``other_device``; spans, their device ranges and (on the CPU) an
    operator inside another are not work."""
    dev = "CUDA" if cuda else "CPU"
    name = "count_kernel<1>" if cuda else "aten::add"
    events = [
        _Event("mask_ground_points", "CPU", 100, 200, annotation=True),
        _Event("spatial_clustering", "CPU", 300, 400, annotation=True),
        _Event(name, dev, 110, 130),
        _Event(name, dev, 190, 200),
        _Event(name, dev, 310, 350),
        _Event(name, dev, 10, 15),                      # before any span
        # the span's device range; the launch on the host (not work on
        # the card) or an operator inside another (not outermost)
        _Event("spatial_clustering", "CUDA", 300, 400, annotation=True),
        _Event("cudaLaunchKernel" if cuda else "aten::mul", "CPU", 115, 125),
    ]
    got = bench.stage_device_seconds(events, sorted(STAGES), cuda)
    assert got["mask_ground_points"] == pytest.approx(30e-9)
    assert got["spatial_clustering"] == pytest.approx(40e-9)
    assert got["other_device"] == pytest.approx(5e-9)
    assert sum(got.values()) == pytest.approx(75e-9)
