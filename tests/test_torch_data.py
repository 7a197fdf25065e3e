"""Port parity: data loading (``data/loader.py``, ``data/packed.py``).

``TokenDataset`` windows and batches, ``PackedDataset`` rows (oversize
documents included) and ``DataLoader.batch_at`` against the JAX package's
(a one-device mesh; several steps and epochs, both splits, flat and
packed), the loader's contract (holdout disjoint and exhaustive, the
``eval_view`` and too-small refusals, prefetch equal to sequential), and a
packed batch's loss through the model against JAX's ``segment_ids`` loss
(xla, and flash through the plain versions).  Arrays are compared exactly;
the loss within the ``TOL = 1e-5`` of ``tests/test_torch_train.py``.  JAX
is imported inside the fixtures, so the ``gpu`` case runs on the card
without it.
"""

import numpy as np
import pytest
import torch

from tpu_parallel_torch.data import DataLoader, PackedDataset, TokenDataset

# one torch intra-op thread per test process (pytest-xdist shares the cores)
torch.set_num_threads(1)

TOL = 1e-5
EOS = 3


@pytest.fixture
def token_file(tmp_path):
    tokens = np.random.default_rng(0).integers(0, 256, size=10_000, dtype=np.uint16)
    path = tmp_path / "corpus.bin"
    TokenDataset.write_bin(str(path), tokens)
    return str(path), tokens


def _doc_stream(seed=0, n_docs=200, max_len=14, oversize=()):
    """EOS-terminated documents of 3..max_len tokens (ids 4..29), with
    documents of the lengths in ``oversize`` spliced in."""
    rng = np.random.default_rng(seed)
    docs = [np.append(rng.integers(4, 30, int(rng.integers(3, max_len))), EOS)
            for _ in range(n_docs)]
    for i, n in enumerate(oversize):
        docs.insert(7 * (i + 1), np.append(rng.integers(4, 30, n), EOS))
    return np.concatenate(docs).astype(np.uint16)


@pytest.fixture(scope="module")
def jax_data():
    """The JAX package's data module and a one-device mesh."""
    import jax

    from tpu_parallel import data
    from tpu_parallel.runtime import MeshConfig, make_mesh

    return data, make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])


def _fields(batch):
    return {name: None if getattr(batch, name) is None else np.asarray(getattr(batch, name))
            for name in ("tokens", "targets", "loss_mask", "segment_ids", "positions")}


def _assert_batches_equal(got, want):
    g, w = _fields(got), _fields(want)
    for name in g:
        assert (g[name] is None) == (w[name] is None), name
        if w[name] is not None:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_token_dataset_windows_and_batches_match_jax(token_file, jax_data, tmp_path):
    jdata, _ = jax_data
    path, tokens = token_file
    for seq in (16, 64):
        got, want = TokenDataset(path, seq), jdata.TokenDataset(path, seq)
        assert got.num_windows == want.num_windows == (10_000 - 1) // seq
        for i in (0, 3, got.num_windows - 1):
            np.testing.assert_array_equal(got.window(i), want.window(i))
        order = np.array([0, 5, 7, got.num_windows - 1])
        _assert_batches_equal(got.batch(order), want.batch(order))
    # a sharded corpus: windows never cross files
    a, b = np.arange(0, 33, dtype=np.uint16), np.arange(100, 117, dtype=np.uint16)
    pa, pb = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    TokenDataset.write_bin(pa, a)
    TokenDataset.write_bin(pb, b)
    got, want = TokenDataset([pa, pb], 16), jdata.TokenDataset([pa, pb], 16)
    assert got.num_windows == want.num_windows == 3
    for i in range(3):
        np.testing.assert_array_equal(got.window(i), want.window(i))


@pytest.mark.parametrize("seq", [8, 32])
def test_packed_rows_match_jax(jax_data, seq):
    """First-fit rows, segment ids, positions and loss masks equal JAX's,
    with documents longer than a row split across rows."""
    jdata, _ = jax_data
    stream = _doc_stream(oversize=(20, 45, 70))
    got, want = PackedDataset(stream, seq, eos_id=EOS), jdata.PackedDataset(stream, seq, eos_id=EOS)
    assert got.num_windows == want.num_windows
    for i in range(got.num_windows):
        for g, w in zip(got.row(i), want.row(i)):
            np.testing.assert_array_equal(g, w)
    order = np.arange(0, got.num_windows, 3)
    _assert_batches_equal(got.batch(order), want.batch(order))


def test_packed_dataset_rows():
    """The JAX package's worked example: whole documents, segment ids,
    restarting positions, each document's last token out of the loss."""
    eos = 9
    stream = np.asarray([1, 2, eos, 3, 4, 5, eos, 6, eos, 7, 8, eos], np.uint16)
    ds = PackedDataset(stream, seq_len=8, eos_id=eos)
    assert ds.num_windows == 2
    tokens, targets, seg, pos, mask = ds.row(0)
    np.testing.assert_array_equal(tokens, [1, 2, eos, 3, 4, 5, eos, eos])
    np.testing.assert_array_equal(seg, [1, 1, 1, 2, 2, 2, 2, 0])
    np.testing.assert_array_equal(pos, [0, 1, 2, 0, 1, 2, 3, 0])
    np.testing.assert_array_equal(mask, [1, 1, 0, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(targets[3:6], [4, 5, eos])
    with pytest.raises(ValueError, match="no eos_id"):
        PackedDataset(np.arange(10, 20, dtype=np.uint16), 8, eos_id=eos)


@pytest.mark.parametrize("kind", ["flat", "packed"])
def test_loader_batch_at_matches_jax(token_file, jax_data, kind):
    """``batch_at`` over three epochs, train and eval splits, equals the JAX
    loader's on a one-device mesh; device tensors are int64 ids, int32
    segment ids and fp32 masks."""
    jdata, mesh = jax_data
    if kind == "flat":
        path, _ = token_file
        ours, theirs = TokenDataset(path, 16), jdata.TokenDataset(path, 16)
    else:
        stream = _doc_stream(n_docs=400, oversize=(40,))
        ours = PackedDataset(stream, 16, eos_id=EOS)
        theirs = jdata.PackedDataset(stream, 16, eos_id=EOS)
    got = DataLoader(ours, 8, seed=2, holdout_fraction=0.2, device="cpu")
    want = jdata.DataLoader(theirs, mesh, 8, seed=2, holdout_fraction=0.2)
    assert got.batches_per_epoch == want.batches_per_epoch
    steps = [0, 1, got.batches_per_epoch - 1, got.batches_per_epoch,
             2 * got.batches_per_epoch + 3]
    for step in steps:
        batch = got.batch_at(step)
        _assert_batches_equal(batch, want.batch_at(step))
    assert batch.tokens.dtype == torch.int64 and batch.loss_mask.dtype == torch.float32
    if kind == "packed":
        assert batch.segment_ids.dtype == torch.int32 and int(batch.segment_ids.max()) >= 2
    ev, jev = got.eval_view(), want.eval_view()
    assert ev.num_windows == jev.num_windows
    for step in (0, ev.batches_per_epoch):
        _assert_batches_equal(ev.batch_at(step), jev.batch_at(step))


def test_holdout_split_disjoint_and_exhaustive(token_file):
    """Eval windows are the stream's tail and never sampled by train."""
    path, tokens = token_file
    ds = TokenDataset(path, seq_len=16)
    train = DataLoader(ds, 8, seed=3, holdout_fraction=0.25, device="cpu")
    ev = train.eval_view()
    n_eval = int(round(ds.num_windows * 0.25))
    assert train.num_windows == ds.num_windows - n_eval and ev.num_windows == n_eval
    starts = {tuple(tokens[w * 16:w * 16 + 16].astype(np.int64)): w for w in range(ds.num_windows)}

    def window_ids(loader, epochs):
        seen = set()
        for step in range(epochs * loader.batches_per_epoch):
            for row in loader.batch_at(step).tokens.numpy():
                seen.add(starts[tuple(row)])
        return seen

    train_ids, eval_ids = window_ids(train, 3), window_ids(ev, 1)
    assert train_ids.isdisjoint(eval_ids)
    assert max(train_ids) < ds.num_windows - n_eval <= min(eval_ids)
    # an epoch visits each of its windows once
    assert len(window_ids(train, 1)) == train.batches_per_epoch * 8
    assert len(eval_ids) == ev.batches_per_epoch * 8


def test_loader_contract(token_file):
    """The refusals (no holdout, a split smaller than a batch, a global
    batch the processes do not divide, as JAX's), process ``p`` of ``P``
    taking rows ``p::P`` of the one-process batch, ``batch_at`` purity, and
    prefetch equal to sequential."""
    path, _ = token_file
    ds = TokenDataset(path, seq_len=16)
    with pytest.raises(ValueError, match="holdout_fraction"):
        DataLoader(ds, 8, device="cpu").eval_view()
    with pytest.raises(ValueError, match="fewer than one global batch"):
        DataLoader(ds, ds.num_windows + 1, device="cpu")
    with pytest.raises(ValueError, match="global batch 8 not divisible by process count 3"):
        DataLoader(ds, 8, device="cpu", process_count=3, process_index=0)
    whole = DataLoader(ds, 8, seed=5, device="cpu")
    assert (whole.process_count, whole.process_index, whole.local_batch_size) == (1, 0, 8)
    for p in range(2):
        part = DataLoader(ds, 8, seed=5, device="cpu", process_count=2, process_index=p)
        assert part.local_batch_size == 4
        for step in (0, 3, part.batches_per_epoch):
            assert torch.equal(part.batch_at(step).tokens, whole.batch_at(step).tokens[p::2])
    a = DataLoader(ds, 8, seed=5, device="cpu")
    b = DataLoader(ds, 8, seed=5, device="cpu")
    assert torch.equal(a.batch_at(40).tokens, b.batch_at(40).tokens)
    assert not torch.equal(a.batch_at(0).tokens, a.batch_at(a.batches_per_epoch).tokens)
    it = a.prefetch(lookahead=3)
    for step in range(5):
        assert torch.equal(next(it).tokens, b.batch_at(step).tokens)
    assert [x.tokens.shape for x in a.epoch(1)][0] == (8, 16)


@pytest.fixture(scope="module")
def packed_pair():
    """A packed batch (4 rows of 32) and bridged tiny weights, both sides."""
    import jax
    import jax.numpy as jnp

    from tpu_parallel.models import gpt as jgpt

    ds = PackedDataset(_doc_stream(n_docs=60), 32, eos_id=EOS)
    batch = ds.batch(np.arange(4))
    model = jgpt.GPTLM(jgpt.tiny_test(remat=False))
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(batch.tokens), train=False)["params"]
    return batch, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_packed_batch_loss_matches_jax(packed_pair, impl):
    """A packed batch's loss and metrics equal JAX's ``segment_ids`` loss on
    the same weights (flash: the JAX interpret-mode kernel against the
    port's plain versions on the CPU)."""
    import jax
    import jax.numpy as jnp

    from tpu_parallel.core.metrics import compute as jax_compute
    from tpu_parallel.core.state import TextBatch as JTextBatch
    from tpu_parallel.models import gpt as jgpt
    from tpu_parallel_torch.core.metrics import compute
    from tpu_parallel_torch.data import to_device
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.convert import params_from_jax
    from tpu_parallel_torch.models.gpt import make_gpt_loss

    batch, params = packed_pair
    jcfg = jgpt.tiny_test(remat=False, attn_impl=impl)
    jbatch = JTextBatch(**{k: jnp.asarray(v) for k, v in _fields(batch).items()})
    want_loss, want_metrics = jgpt.make_gpt_loss(jcfg)(
        jax.tree.map(jnp.asarray, params), jgpt.GPTLM(jcfg).apply, jbatch, jax.random.PRNGKey(0))
    cfg = tiny_test(remat=False, attn_impl=impl)
    model = GPTLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    with torch.no_grad():
        loss, metrics = make_gpt_loss(cfg)(model, to_device(batch, "cpu"))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    got = compute(metrics)
    for key, value in jax_compute(want_metrics).items():
        np.testing.assert_allclose(got[key], value, rtol=TOL)
    # the segments matter: the same rows without their ids give another loss
    unpacked = to_device(batch, "cpu")
    unpacked.segment_ids = None
    with torch.no_grad():
        assert abs(make_gpt_loss(cfg)(model, unpacked)[0].item() - loss.item()) > 1e-4


@pytest.mark.gpu
def test_packed_flash_gradients_match_plain_on_card():
    """On the card: a packed batch's flash gradients through both kernels
    against the same weights on the CPU's plain versions (fp32 model, bf16
    kernels inside: relative L2 error per weight under 5e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_parallel_torch.data import to_device
    from tpu_parallel_torch.models import GPTLM, tiny_test
    from tpu_parallel_torch.models.gpt import make_gpt_loss

    cfg = tiny_test(attn_impl="flash", seq_len=256, d_model=256, n_heads=4,
                    dtype=torch.bfloat16, remat=True, remat_policy="proj_attn")
    ds = PackedDataset(_doc_stream(n_docs=400, max_len=90), 256, eos_id=EOS)
    batch = ds.batch(np.arange(4))
    grads = {}
    for device in ("cuda", "cpu"):
        model = GPTLM(cfg, device=device, seed=1)
        loss, _ = make_gpt_loss(cfg)(model, to_device(batch, device))
        loss.backward()
        grads[device] = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    for name, want in grads["cpu"].items():
        if name.endswith("attn.qkv.bias"):
            continue  # zero in exact arithmetic for the key slice
        rel = float((grads["cuda"][name] - want).norm() / want.norm().clamp(min=1e-30))
        assert rel <= 5e-2, (name, rel)
