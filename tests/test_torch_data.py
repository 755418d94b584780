"""The port's training data stream (``data.pipeline``).

The reference draws its tokens with ``jax.random.categorical`` (threefry
bits the port cannot reproduce); the port draws from its own seeded
``torch.Generator``. So the stream is held to the reference's structure,
exactly — BOS every ``bos_period`` columns, every third column the raw draw
before it times 31 mod V, labels the tokens shifted by one, this host's rows
of the global batch, a pure function of the step — and to its distribution:
the raw columns' top-ranked token frequencies within 5 sigma of the Zipf
unigram over 100k+ draws. The global RNGs are left as they were. The
reference's own data test is mirrored.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as JDataConfig
from repro.data import batch_at_step as jbatch_at_step
from repro_torch.data import DataConfig, DataIterator, batch_at_step


def test_data_determinism_and_host_sharding():
    dc = DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    a1, b1 = batch_at_step(dc, 7, device="cpu")
    a2, b2 = batch_at_step(dc, 7, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert a1.dtype == torch.int32 and a1.shape == (8, 16)
    # host sharding partitions the global batch
    h0, _ = batch_at_step(dc, 7, host_index=0, host_count=2, device="cpu")
    h1, _ = batch_at_step(dc, 7, host_index=1, host_count=2, device="cpu")
    assert h0.shape == (4, 16)
    assert not torch.equal(h0, h1)
    # labels are next-token shifted
    assert torch.equal(a1[:, 1:], b1[:, :-1])
    assert not torch.equal(batch_at_step(dc, 8, device="cpu")[0], a1)
    with pytest.raises(ValueError, match="does not split"):
        batch_at_step(dc, 0, host_count=3, device="cpu")


@pytest.mark.parametrize("vocab,seq,bos", [(256, 200, 64), (49152, 130, 7)],
                         ids=["reduced", "granite_vocab"])
def test_stream_structure_is_the_reference(vocab, seq, bos):
    dc = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=6, seed=3, bos_period=bos)
    jtoks, jlabels = (np.asarray(a) for a in jbatch_at_step(
        JDataConfig(vocab_size=vocab, seq_len=seq, global_batch=6, seed=3, bos_period=bos), 2))
    toks, labels = batch_at_step(dc, 2, device="cpu")
    assert toks.shape == jtoks.shape and labels.shape == jlabels.shape
    for t, lab in ((toks.numpy(), labels.numpy()), (jtoks, jlabels)):
        full = np.concatenate([t, lab[:, -1:]], axis=1)           # the S + 1 draws
        np.testing.assert_array_equal(t[:, 1:], lab[:, :-1])
        cols = np.arange(seq + 1)
        assert np.all(full[:, cols % bos == 0] == 1)
        # a mix column is the raw draw before it * 31 % V; the one before
        # is raw unless it is itself a BOS column
        for c in cols[(cols % 3 == 0) & (cols % bos != 0) & ((cols - 1) % bos != 0)]:
            np.testing.assert_array_equal(full[:, c], full[:, c - 1] * 31 % vocab)
        assert full.min() >= 0 and full.max() < vocab


def test_unigram_is_zipf_within_5_sigma():
    dc = DataConfig(vocab_size=1000, seq_len=511, global_batch=16, seed=5)
    cols = np.arange(dc.seq_len + 1)
    raw_cols = (cols % 3 != 0) & (cols % dc.bos_period != 0)
    draws = []
    for step in range(20):
        toks, labels = batch_at_step(dc, step, device="cpu")
        full = torch.cat([toks, labels[:, -1:]], dim=1).numpy()
        draws.append(full[:, raw_cols].ravel())
    draws = np.concatenate(draws)
    n = draws.size
    assert n >= 100_000
    ranks = np.arange(1, dc.vocab_size + 1, dtype=np.float64)
    p = ranks ** -dc.zipf_alpha
    p /= p.sum()
    top = 20
    freq = np.bincount(draws, minlength=dc.vocab_size)[:top] / n
    sigma = np.sqrt(p[:top] * (1 - p[:top]) / n)
    assert np.all(np.abs(freq - p[:top]) <= 5 * sigma), np.abs(freq - p[:top]) / sigma


def test_global_rngs_untouched_and_iterator_resumes():
    torch_state, np_state = torch.get_rng_state(), np.random.get_state()
    dc = DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    it = DataIterator(dc, start_step=5, device="cpu")
    first, second = next(it), next(it)
    assert torch.equal(torch.get_rng_state(), torch_state)
    assert all(np.array_equal(a, b) for a, b in zip(np.random.get_state(), np_state))
    for got, step in ((first, 5), (second, 6)):
        want = batch_at_step(dc, step, device="cpu")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert it.step == 7
