"""The check's numbers on hand-made rows: a tie at the kth neighbour
in float32 leaves the row out of the set-reading numbers only."""

import numpy as np


def rows(n=4, k=3):
    d2 = np.tile(np.array([1.0, 2.0, 3.0]), (n, 1)) * 1e-4
    ref = {"d2": d2, "d2_next": np.full(n, 4e-4),
           "normals": np.tile([0.0, 0.0, 1.0], (n, 1)),
           "K": np.ones(n), "H": np.ones(n), "k1": np.ones(n),
           "k2": np.ones(n)}
    sample = {"cloud": np.zeros(n, int), "row": np.arange(n),
              "kth": np.sqrt(d2[:, -1]).astype(np.float32),
              "normals": ref["normals"].astype(np.float32),
              "K": np.ones(n, np.float32), "H": np.ones(n, np.float32),
              "k1": np.ones(n, np.float32), "k2": np.ones(n, np.float32),
              "exact": np.ones(n, bool)}
    return sample, ref


def test_a_sound_sample_reads_nought():
    from bench_port.check import numbers

    sample, ref = rows()
    nums = numbers(sample, ref, None)
    assert nums["K_err"] < 1e-7 and nums["knn_bad_share"] == 0.0
    assert nums["tied_rows"] == 0 and nums["sign_flip_share"] == 0.0


def test_a_tied_row_leaves_the_fit_numbers_only():
    from bench_port.check import numbers

    sample, ref = rows()
    ref["d2_next"][1] = ref["d2"][1, -1] * (1 + 2e-7)   # float32 tie
    sample["K"][1] = 1.05                               # the other choice
    sample["kth"][1] *= np.float32(1.5)                 # but a wrong kth
    nums = numbers(sample, ref, None)
    assert nums["tied_rows"] == 1
    assert nums["K_err"] < 1e-7                         # left out
    assert nums["kth_rel"] > 0.4                        # still read
    sample["K"][2] = 1.05                               # an untied row
    assert numbers(sample, ref, None)["K_err"] > 0.02


def test_a_flipped_normal_negates_h():
    from bench_port.check import numbers

    sample, ref = rows()
    ref["H"][:] = 2.0
    ref["k1"][:], ref["k2"][:] = 3.0, 1.0
    sample["normals"][0] *= -1
    sample["H"][0] = -2.0
    sample["k1"][0], sample["k2"][0] = -1.0, -3.0
    sample["H"][1:] = 2.0
    sample["k1"][1:], sample["k2"][1:] = 3.0, 1.0
    nums = numbers(sample, ref, None)
    assert nums["sign_flip_share"] == 0.25
    assert nums["H_err"] < 1e-7 and nums["k12_err"] < 1e-7


def test_uncertified_rows_are_read_too():
    """A row the route leaves uncertified is out of the certified
    numbers but read by ``K_p99_all``."""
    from bench_port.check import numbers

    sample, ref = rows(n=200)
    sample["exact"][:3] = False
    sample["K"][:3] = 1.5
    nums = numbers(sample, ref, None)
    assert nums["K_err"] < 1e-7 and nums["K_p99"] < 1e-7
    assert nums["K_p99_all"] > 0.1
    assert nums["knn_bad_share"] == 0.015
