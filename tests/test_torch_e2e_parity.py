"""The port's composed end-to-end quality parity
(``vilgod_tpu_torch.tools.parity_oracle.measure_delta_ap``) on the CPU:
the port's geometry stages feed both its table decision stages and its
transcribed reference oracle, both detection sets score with the port's
Waymo-protocol AP against the same GT, and the per-class |ΔAP| is 0.0
(tests/test_e2e_parity.py's scene and caps; its JAX counterpart is slow,
the port's stages run this scene in about a minute on one thread)."""
import pytest
import torch

from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.tools.parity_oracle import measure_delta_ap


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_composed_delta_ap_is_zero():
    # tests/test_e2e_parity.py's caps: no cluster truncates, so the table
    # side's capacity cap cannot part it from the oracle
    cap = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
           "max_cluster_points": 8192, "max_tracks": 64,
           "max_cluster_input": 8192, "clip_batch": 8}
    ds = SyntheticDataset(n_sequences=1, n_frames=12, seed=12, n_ground=2500,
                          n_vehicles=3, n_pedestrians=1, n_cyclists=1,
                          n_moving=0, area=40.0)
    out = measure_delta_ap(waymo_config(capacity=cap), ds,
                           ds.sequence_names()[0],
                           eval_range=(-40.0, -40.0, 40.0, 40.0),
                           device="cpu")
    assert out["n_dets_table"] > 0 and out["n_dets_oracle"] > 0
    assert out["n_truncated"] == 0
    assert any(v["table"] > 0 for v in out["per_class"].values()), out
    assert out["delta_ap_max"] <= 0.5, out
    assert out["delta_ap_max"] == 0.0, out
    assert set(out["per_class"]) == {"Vehicle", "Pedestrian", "Cyclist"}
