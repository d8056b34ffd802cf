"""The wide route of the fused contraction on a card (marked ``card``;
skipped without one): its kernel against its plain version
(``fused_predict.wide_reference``), the same bits over repeated calls, and
a CUDA graph's replays against the eager calls, with their launch counts.
Its plain version and route are tested on the CPU in
``tests/test_torch_fused_predict.py``. This file imports no JAX: it runs on
a machine without it (``python3 -m pytest --noconftest
tests/test_torch_wide.py -m card``)."""

import numpy as np
import pytest
import torch

from sgdml_tpu_torch.ops import fused_predict


def _rel(ours, ref):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.fixture
def card():
    """Skips the test where PyTorch sees no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: PyTorch sees none here')
    return torch.device('cuda')


def _wide_inputs(B, T, D, dtype, with_aE, device, seed):
    """``chip_smoke.contraction_inputs``: centred descriptor-like tables and
    queries from a numpy seed, and sig near the typical distance."""
    import chip_smoke

    return chip_smoke.contraction_inputs(B, T, D, dtype, with_aE, seed, device)


@pytest.mark.card
@pytest.mark.parametrize('clusters', [None, 7])
@pytest.mark.parametrize('shape', [(37, 8193), (600, 10_878)], ids=['ragged', 'buckyball'])
@pytest.mark.parametrize('B', [1, 3, fused_predict.WIDE_MAX_B])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32], ids=['f64', 'f32'])
@pytest.mark.parametrize('with_aE', [False, True])
def test_wide_kernel_matches_its_plain_version_on_the_card(card, with_aE, dtype, B, shape, clusters):
    """The wide kernel and its reduction against ``wide_reference`` with the
    same clusters (the card's, or 7), at a ragged shape (D = 8,193: slices
    of 2,049 and a last of 2,046; T = 37) and at the buckyball catcher's
    width: F_d within 1e-12 (f64) and 1e-5 (f32) of max |F_d|, E within
    those of the sum of its terms' magnitudes (at B = 1 the terms can
    nearly cancel); a second call gives the same bits."""
    T, D = shape
    args = _wide_inputs(B, T, D, dtype, with_aE, card, seed=B + T)
    E, F_d = fused_predict.wide(*args, clusters=clusters)
    n = clusters or min(T, fused_predict._wide_max_clusters(card.index or 0, dtype, B))
    E_ref, F_ref = fused_predict.wide_reference(*args, n)
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    e_scale = fused_predict._plane_terms(*args)[0].abs().sum(1).max()
    assert torch.isfinite(F_d).all() and float((E - E_ref).abs().max() / e_scale) <= bound
    assert _rel(F_d.cpu(), F_ref.cpu()) <= bound
    E2, F2 = fused_predict.wide(*args, clusters=clusters)
    assert torch.equal(E, E2) and torch.equal(F_d, F2)


@pytest.mark.card
@pytest.mark.parametrize('B', [1, fused_predict.WIDE_MAX_B])
def test_wide_graph_replays_the_eager_bits_and_counts_on_the_card(card, B):
    """Three calls captured in a CUDA graph (recorded, not counted) replay
    the bits of the same calls run eagerly, and each replay counts its
    three wide launches in ``PATH_LAUNCHES``, as ``fused_predict_tables``
    routes one to four geometries at the buckyball catcher's width."""
    args = _wide_inputs(B, 600, 10_878, torch.float64, True, card, seed=3)
    assert fused_predict.route(10_878, B) == 'wide'
    eager = [fused_predict.fused_predict_tables(*args) for _ in range(3)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fused_predict.fused_predict_tables(*args)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    fused_predict.reset_launches()
    graph = torch.cuda.CUDAGraph()
    with fused_predict.recording_launches() as recorded, torch.cuda.graph(graph):
        outs = [fused_predict.fused_predict_tables(*args) for _ in range(3)]
    assert fused_predict.PATH_LAUNCHES['wide'] == fused_predict.LAUNCHES == 0
    assert recorded == {'total': 3, 'wide': 3}
    for replay in range(2):
        graph.replay()
        fused_predict.count_replay(recorded)
        torch.cuda.synchronize()
        for (E, F_d), (E_e, F_e) in zip(outs, eager):
            assert torch.equal(E, E_e) and torch.equal(F_d, F_e)
    assert fused_predict.PATH_LAUNCHES['wide'] == fused_predict.LAUNCHES == 6
    assert fused_predict.PATH_LAUNCHES['pass_a'] == fused_predict.PATH_LAUNCHES['split_t'] == 0
