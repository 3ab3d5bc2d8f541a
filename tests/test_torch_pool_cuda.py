"""On the card: the page-locked batch pool (data/pipeline.py::BatchPool,
buffers from cudaHostAlloc) and PatchGCN's determinism.

- Each batch's copy to the card is queued behind ~10 ms of other work, so
  it is still in flight when the consumer asks for the next batch (the
  copy call returns at once: the buffer is page-locked); with 2 or 4
  buffers the producer reaches that batch's buffer again while the copy
  waits.  Every batch that arrives on the card must equal the batch built
  without the pool: a buffer written again before its copy ran would show
  the later batch's values.
- PatchGCN's evaluation and its training gradients (segment sums over the
  edge lists, no atomics) give the same bits run to run.

They skip without a card, and import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pool_cuda.py
"""
import numpy as np
import pytest
import torch

from vlsa_tpu_torch.data.io import grid_edge_index
from vlsa_tpu_torch.data.pipeline import BagBatcher, BatchPool
from vlsa_tpu_torch.models.registry import load_model

pytestmark = pytest.mark.cuda
SLEEP_CYCLES = 20_000_000  # ~10 ms of a kernel that only waits, at ~1.8 GHz
LABELS = ("t", "e", "idx", "valid")  # the batch entries outside the pool


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pool page-locks through CUDA")
    return torch.device("cuda")


class _Bags:
    mode = "patch"

    def __init__(self, lengths, D=256):
        self.lengths, self.D = lengths, D

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.normal(size=(self.lengths[i], self.D)).astype(np.float32),
                np.array([i % 4, i % 2], np.float32))


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("feats_dtype", ["float32", "int8"])
def test_pool_never_hands_out_a_buffer_whose_copy_is_in_flight(device, prefetch, feats_dtype):
    ds = _Bags(np.random.default_rng(0).integers(100, 3000, size=48).tolist())
    kw = dict(batch_size=4, min_bucket=256, feats_dtype=feats_dtype)
    ref = BagBatcher(ds, **kw)
    want = [ref.make_batch(c) for c in ref.batch_indices()]
    pool = BatchPool(page_locked=True)
    got = []
    for batch in BagBatcher(ds, prefetch=prefetch, pool=pool, **kw):
        assert batch.buffer is not None and batch["feats"].is_pinned()
        # the destinations first: a new device block's cudaMalloc would wait
        # for the stream
        pooled = {k: torch.empty_like(v, device=device) for k, v in batch.items()
                  if k not in LABELS}
        torch.cuda._sleep(SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
        for k, dst in pooled.items():
            dst.copy_(batch[k], non_blocking=True)
        # page-locked: the copy calls returned before the work ahead of them
        # ran (the labels, pageable, are copied after this check: a pageable
        # copy may wait for the stream)
        assert not slept.query()
        got.append(dict(pooled, **{k: batch[k].to(device) for k in LABELS}))
    del batch
    torch.cuda.synchronize()
    assert len(got) == len(want) and len(pool.free) <= prefetch + 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k].cpu(), w[k]), (i, k)
    assert sum(b.numel() for b, _e in pool.free) == pool.nbytes
    pool.release()
    assert pool.free == [] and pool.nbytes == 0


def test_patchgcn_is_bit_identical_run_to_run(device):
    rng = np.random.default_rng(1)
    B, D, lengths = 4, 128, [5000, 3100, 4097, 700]
    N = max(lengths)
    feats = torch.zeros(B, N, D)
    mask = torch.zeros(B, N, dtype=torch.bool)
    edges = [grid_edge_index(n) for n in lengths]
    E = max(e.shape[1] for e in edges)
    ei = torch.zeros(B, 2, E, dtype=torch.int32)
    ev = torch.zeros(B, E, dtype=torch.bool)
    for j, (n, e) in enumerate(zip(lengths, edges)):
        feats[j, :n] = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
        mask[j, :n] = True
        ei[j, :, :e.shape[1]] = torch.from_numpy(e.astype(np.int32))
        ev[j, :e.shape[1]] = True
    model = load_model("DeepMIL", [D, 64, 12], device=device, network="PatchGCN").eval()
    args = [t.to(device) for t in (feats, mask, ei, ev)]
    with torch.inference_mode():
        runs = [model(args[0], args[1], edge_index=args[2], edge_valid=args[3])
                for _ in range(3)]
    assert torch.isfinite(runs[0]).all()
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    with torch.inference_mode():
        cpu = load_model("DeepMIL", [D, 64, 12], device="cpu", network="PatchGCN",
                         state_dict={k: v.cpu() for k, v in model.state_dict().items()}).eval()
        want = cpu(feats, mask, edge_index=ei, edge_valid=ev)
    assert (runs[0].cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    grads = []
    for _ in range(3):
        model.zero_grad(set_to_none=True)
        model(args[0], args[1], edge_index=args[2], edge_valid=args[3]).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert "gcn.conv0.mlp1.weight" in grads[0] and "gcn.fc.weight" in grads[0]
    assert all(g.keys() == grads[0].keys() for g in grads[1:])
    for g in grads[1:]:
        for n in g:
            assert torch.equal(g[n], grads[0][n]), n
