"""The benchmark's copy of the scene generator: the same seed makes the
same frames, in one process or in workers, and the program's generator
makes the same frames too."""
import numpy as np

from benchmark import scenes

SCENE = dict(n_frames=6, n_ground=2000, n_vehicles=2, n_pedestrians=1,
             n_cyclists=1, n_moving=1, area=40.0)


def test_deterministic_under_seed():
    big = 2**31 + 12345
    a = scenes.make_sequences(SCENE, big, 2, workers=1, chunk=4)
    b = scenes.make_sequences(SCENE, big, 2, workers=2, chunk=4)
    c = scenes.make_sequences(SCENE, big + 1, 1, workers=1)
    for sa, sb in zip(a, b):
        assert len(sa.frames) == SCENE["n_frames"]
        for fa, fb in zip(sa.frames, sb.frames):
            np.testing.assert_array_equal(fa, fb)
        for pa, pb in zip(sa.poses, sb.poses):
            np.testing.assert_array_equal(pa, pb)
    assert not np.array_equal(a[0].frames[0], c[0].frames[0])


def test_same_frames_as_the_programs_generator():
    from vilgod_tpu_torch.data.synthetic import SyntheticSequence
    seed = scenes.sequence_seed(7, 1)
    ours = scenes.SyntheticSequence(seed=seed, **SCENE)
    theirs = SyntheticSequence(seed=seed, **SCENE)
    for f in range(SCENE["n_frames"]):
        np.testing.assert_array_equal(ours.frame(f),
                                      theirs.get_lidar_points(f))
