"""The plain reference against the port's plain torch path
(``backend="torch"``, ``device="cpu"``) at a tiny size."""

import pytest
import torch

from portbench import generate
from portbench.reference import plain
from repro_torch.core import distances, engine
from repro_torch.kernels import ops


@pytest.fixture(scope="module")
def frames():
    gen = generate.torch_generator(2 ** 31 + 7, generate.FRAMES, "cpu")
    return generate.structured_frames(3, 40, 56, gen, "cpu")


def _ids(frames, nb):
    return plain.bin_ids(frames, nb, 256)


@pytest.mark.parametrize("nb", [1, 7, 16])
def test_h_rows_equal_the_ports_integral_histogram(frames, nb):
    rows = [0, 5, 17, 39]
    H = ops.integral_histogram(frames.numpy(), nb, backend="torch",
                               device="cpu")
    want = H[..., rows, :]
    got = plain.h_rows(_ids(frames, nb), nb, rows)
    assert torch.equal(got.to(torch.float32), want)


def test_bin_ids_equal_the_ports_binning(frames):
    from repro_torch.core.binning import bin_indices

    for nb in (3, 32, 128):
        assert torch.equal(plain.bin_ids(frames, nb, 256),
                           bin_indices(frames, nb, 256).to(torch.int64))


@pytest.mark.parametrize("window,stride", [((8, 8), 1), ((9, 5), 3),
                                           ((40, 56), 1)])
def test_window_counts_equal_the_ports_sliding_windows(frames, window,
                                                       stride):
    from repro_torch.core import region_query as rq

    H = ops.integral_histogram(frames.numpy(), 8, backend="torch",
                               device="cpu")
    want = rq.sliding_window_histograms(H, window, stride)
    got = plain.window_counts(_ids(frames, 8), 8, window, stride)
    assert torch.equal(got.to(torch.float32), want)


def test_likelihood_equals_the_ports(frames):
    ids = _ids(frames, 8)
    target = torch.bincount(ids[0, 4:20, 8:24].reshape(-1),
                            minlength=8).to(torch.float32)
    eng = engine.HistogramEngine(num_bins=8, device="cpu")
    for window, stride in (((16, 16), 2), ((8, 8), 1), ((24, 24), 4)):
        res = eng.run(frames.numpy(), [engine.LikelihoodQuery(
            target.numpy(), window, stride=stride)]).results
        assert torch.equal(res[0], plain.likelihood_map(ids, 8, target,
                                                         window, stride))
    # The metric itself, against the port's intersection.
    hists = plain.window_counts(ids, 8, (16, 16), 2).to(torch.float32)
    assert torch.equal(plain.intersection(hists, target),
                       distances.intersection(hists, target))


def test_the_control_rounds_counts_past_256():
    flat = torch.zeros((1, 37, 61), dtype=torch.uint8)      # one bin
    ids = plain.bin_ids(flat, 4, 256)
    exact = plain.h_rows(ids, 4, [36])
    rounded = plain.h_rows(ids, 4, [36], torch.bfloat16)
    assert int(exact.max()) == 37 * 61 and float(rounded.max()) == 2256.0
    assert torch.equal(rounded[..., :6], exact[..., :6].to(torch.float32))
