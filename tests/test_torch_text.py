"""The port's text pipeline against the JAX package on the CPU: the
word2vec helpers, the ``.vec`` reader, the literal autoencoder (one epoch
from the JAX initialisation: loss, parameters and codes at rtol 1e-5), its
linear 'thah' quirk, one character-SGNS step against a numpy transcription
of the JAX step (rtol 1e-5), and the SGNS similar-contexts property."""
import numpy as np
import pytest
import torch

from multike_tpu.config import Config as JConfig
from multike_tpu.text import autoencoder as jae
from multike_tpu.text import word2vec as jw2v
from multike_tpu_torch.config import Config
from multike_tpu_torch.text import autoencoder as tae
from multike_tpu_torch.text import char_sgns
from multike_tpu_torch.text import word2vec as tw2v
from multike_tpu_torch.text.literal_encoder import LiteralEncoder
from multike_tpu_torch.utils import native as tnative

# The parameters start standard normal, so their scale is 1: atol 1e-5 is
# rtol 1e-5 of that scale for the entries that pass near zero. (The
# gradient through the whole-batch norm of h cancels large terms, and the
# two packages sum them in different orders.)
AE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the steps here are many tiny ops, which the
    thread pool slows by orders of magnitude when test workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls, **kw):
    base = dict(dim=8, batch_size=64, encoder_epoch=1, tokens_max_len=3,
                word2vec_dim=4, learning_rate=0.01)
    base.update(kw)
    return cls(**base)


def _w2v(rng, words, dim=4):
    return {w: rng.normal(size=dim).astype(np.float32) for w in words}


def test_word2vec_helpers_equal_jax():
    rng = np.random.RandomState(0)
    w2v = _w2v(rng, ["alpha", "beta", "gamma", "delta"])
    literals = ["alpha beta", "gamma zzz delta alpha", "", "unknown", "beta"]
    ids = {i: lit for i, lit in enumerate(literals)}
    np.testing.assert_array_equal(
        tw2v.literal_token_matrix(literals, w2v, 3, 4),
        jw2v.literal_token_matrix(literals, w2v, 3, 4))
    words = ["aab", "abc", "zq"] * 20 + ["z"]
    assert tw2v.build_alphabet(words) == jw2v.build_alphabet(words)
    chars = _w2v(rng, list("abcz"))
    for got, want in (
            (tw2v.words_from_char_vectors(words, chars, "abz", 4),
             jw2v.words_from_char_vectors(words, chars, "abz", 4)),
            (tw2v.tokens2vec_add(ids, w2v, 4, False),
             jw2v.tokens2vec_add(ids, w2v, 4, False)),
            (tw2v.tokens2vec_add(ids, w2v, 4, True),
             jw2v.tokens2vec_add(ids, w2v, 4, True)),
            (tw2v.look_up_word2vec(ids, w2v, "encoder", True, 4, 3),
             jw2v.look_up_word2vec(ids, w2v, "encoder", True, 4, 3)),
            (tw2v.look_up_char2vec(ids, chars, 4),
             jw2v.look_up_char2vec(ids, chars, 4))):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_read_word2vec_routes_equal(tmp_path):
    p = tmp_path / "w.vec"
    p.write_text("3 4\nfoo 1 2 3 4\nbar 0.5 0 0 -1\nbad 1 2\nfoo 9 8 7 6\n"
                 "baz -0.25 1e-3 2.5 0\n", encoding="utf8")
    py = tnative.read_word2vec_py(str(p), 4)
    assert set(py) == {"foo", "bar", "baz"}
    np.testing.assert_array_equal(py["foo"], [9, 8, 7, 6])  # later wins
    for other in (tnative.read_word2vec(str(p), 4),
                  jw2v.read_word2vec(str(p), 4)):
        assert other.keys() == py.keys()
        for k in py:
            np.testing.assert_array_equal(other[k], py[k])


def test_autoencoder_epoch_matches_jax():
    """From the JAX initialisation, one epoch (two batches, the second
    padded) gives the JAX loss, parameters and codes, with the default
    (linear, 'thah') activation. With tanh the standard-normal weights
    drive the units into saturation, where fp32 rounding of pre-activations
    in the thousands decides the last digits."""
    x = np.random.RandomState(1).normal(size=(100, 20)).astype(np.float32)
    ref = jae.AutoEncoder(x, _cfg(JConfig),
                          input_dim=20)
    ae = tae.AutoEncoder(x, _cfg(Config), input_dim=20,
                         device="cpu")
    tae.autoencoder_params_from_reference(
        ae, {k: np.asarray(v) for k, v in ref.params.items()})
    ref.params, ref.opt_state, want = ref._run_epoch(
        ref.params, ref.opt_state, ref._xp, ref._wp)
    got = ae.train_epoch()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k, p in ae.weights.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(ref.params[k]), **AE_TOL,
                                   err_msg=k)
    want_codes = ref.encode(x)
    np.testing.assert_allclose(ae.encode(x), want_codes, rtol=1e-5,
                               atol=1e-6 * np.abs(want_codes).max())


def test_autoencoder_linear_with_thah_typo():
    cfg = _cfg(Config, encoder_active="thah", encoder_normalize=False)
    x = np.random.RandomState(0).normal(size=(10, 20)).astype(np.float32)
    ae = tae.AutoEncoder(x, cfg, input_dim=20, device="cpu")
    p = {k: v.detach().double().numpy() for k, v in ae.weights.items()}
    w = p["enc_w0"] @ p["enc_w1"] @ p["enc_w2"]
    b = (p["enc_b0"] @ p["enc_w1"] + p["enc_b1"]) @ p["enc_w2"] + p["enc_b2"]
    manual = x.astype(np.float64) @ w + b
    np.testing.assert_allclose(ae.encode(x), manual,
                               atol=1e-5 * np.abs(manual).max())


def test_literal_encoder_encodes_the_raw_matrix():
    """Trained on row-normalized inputs, but the codes are those of the
    raw token matrix."""
    rng = np.random.RandomState(2)
    w2v = _w2v(rng, ["alpha", "beta", "gamma"])
    literals = ["alpha beta", "gamma", "beta gamma alpha", "alpha"]
    cfg = _cfg(Config, encoder_epoch=2, seed=5)
    enc = LiteralEncoder(literals, dict(w2v), cfg, device="cpu")
    raw = tw2v.literal_token_matrix(literals, enc.word2vec, 3, 4)
    np.testing.assert_array_equal(enc.encoded_literal_vector,
                                  enc.auto_encoder.encode(raw))
    assert enc.encoded_literal_vector.shape == (4, 8)


def _np_sgns_step(w_in, w_out, c, o, w, neg, lr):
    """numpy transcription of the JAX package's SGNS step
    (multike_tpu/text/char_sgns.py)."""
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))  # noqa: E731
    batch, dim = c.shape[0], w_in.shape[1]
    c_vec, o_vec, n_vec = w_in[c], w_out[o], w_out[neg]
    g_pos = (sig(np.sum(c_vec * o_vec, 1)) - 1.0) * w
    g_neg = sig(np.einsum("bd,bkd->bk", c_vec, n_vec)) * w[:, None]
    d_c = g_pos[:, None] * o_vec + np.einsum("bk,bkd->bd", g_neg, n_vec)
    d_o = g_pos[:, None] * c_vec
    d_n = g_neg[:, :, None] * c_vec[:, None, :]
    scale = lr / batch
    w_in, w_out = w_in.copy(), w_out.copy()
    np.add.at(w_in, c, -scale * d_c)
    np.add.at(w_out, o, -scale * d_o)
    np.add.at(w_out, neg.reshape(-1), -scale * d_n.reshape(-1, dim))
    return w_in, w_out


def test_char_sgns_step_matches_numpy_transcription():
    rng = np.random.RandomState(3)
    v, dim, batch, k = 7, 16, 32, 5
    w_in = rng.uniform(-0.5, 0.5, (v, dim)).astype(np.float32)
    w_out = rng.normal(0, 0.3, (v, dim)).astype(np.float32)
    c, o = rng.randint(0, v, batch), rng.randint(0, v, batch)
    w = (np.arange(batch) < 27).astype(np.float32)          # padded tail
    neg = rng.randint(0, v, (batch, k))
    want_in, want_out = _np_sgns_step(w_in, w_out, c, o, w, neg, 0.25)
    t_in, t_out = torch.tensor(w_in), torch.tensor(w_out)
    char_sgns.sgns_step(t_in, t_out, torch.as_tensor(c), torch.as_tensor(o),
                        torch.as_tensor(w), torch.as_tensor(neg), 0.25)
    np.testing.assert_allclose(t_in.numpy(), want_in, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_out.numpy(), want_out, rtol=1e-5, atol=1e-7)


def test_char_sgns_similar_contexts():
    # 'a' and 'b' appear in identical contexts; 'z' in a different one
    words = ["xay", "xby", "pzq"] * 50
    vecs = char_sgns.train_char_sgns(words, dim=16, epochs=100, batch=256,
                                     seed=0, device="cpu")

    def cos(u, v):
        return float(np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v)
                                     + 1e-9))
    assert cos(vecs["a"], vecs["b"]) > cos(vecs["a"], vecs["z"])
    pairs = char_sgns.build_pairs(words, 5)
    assert len(pairs[1]) == 150 * 6
