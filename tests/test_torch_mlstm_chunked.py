"""The chunkwise algebra of the mLSTM scan's backward kernel
(``kernels/csrc/mlstm_scan.cu``), on the CPU in float64.

``chunked_backward`` below restates the kernel's algorithm in plain torch,
step for step in its structure: chunks of 32 positions; the decays D(u, s)
= exp(LF_u - LF_s + m_s - m_u) from the forward's saved m (LF the chunk's
running sum of log sigmoid(f)); the chunk-local pass (dq against the
chunk's saved C snapshot plus the 32 x 32 intra-chunk products, and the
intra-chunk parts of dv, dk, N and W); the reverse walk over the chunks
carrying G and N at the chunk boundaries (dv's and dk's boundary terms,
the anchor <G, C_snapshot>, the per-position dot products); and the gate
pass (W exact from the chunk's products, then the stabiliser's chain back
through m, torch.maximum's gradient split at a tie).  It is held against
``torch.autograd.grad`` of ``mlstm_scan_plain`` (the stepped cell) at
1e-10 over lengths that are one position, one chunk and a ragged three
chunks and a bit, head dims 8 and 40, zero and drawn states, ties a_t =
i_t, and |d_t| < 1; and once against ``jax.grad`` of the reference's scan
(``repro.models.recurrent.mlstm``'s ``lax.scan`` over ``_mlstm_cell``)
in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import recurrent as JR
from repro_torch.kernels import mlstm_scan as MS

F64 = dict(rtol=1e-10, atol=1e-10)
L = MS.SNAP_EVERY
B, H = 2, 2
F = dict(dtype=torch.float64)


def _log_sigmoid(x):
    return -MS.softplus(-x)


def chunked_backward(dh, q, k, v, ip, fp, C0, n0, m0, h, n_all, m_all,
                     d_all, snap):
    """The kernel's backward on the forward's inputs and saved outputs:
    (dq, dk, dv, di, df, dC0, dn0, dm0)."""
    hd = q.shape[-1]
    sc = hd ** -0.5
    # log sigmoid(f) a position at a time, as the cell forms it (a tie a_t
    # = i_t must be the forward's, to the last bit)
    lf = torch.stack([_log_sigmoid(fp[:, t]) for t in range(fp.shape[1])],
                     dim=2)
    bhs = lambda t: t.movedim(1, 2)              # (B, S, H, ...) -> (B, H, S, ...)
    q, k, v, dh, h, n_all = map(bhs, (q, k, v, dh, h, n_all))
    ip, fp, m_all, d_all = (t.movedim(1, 2) for t in (ip, fp, m_all, d_all))
    S = q.shape[2]
    # per-position scalars
    m_prev = torch.cat([m0[..., None], m_all[..., :-1]], dim=-1)
    n_prev = torch.cat([n0[:, :, None], n_all[:, :, :-1]], dim=2)
    aa = lf + m_prev
    fe = torch.exp(aa - m_all)
    ie = torch.exp(ip - m_all)
    den = torch.clamp_min(d_all.abs(), 1.0)
    sg = torch.where(d_all.abs() >= 1.0, torch.sign(d_all),
                     torch.zeros_like(d_all))
    dnum = dh / den[..., None]
    dd = -(dh * h).sum(-1) / den * sg
    ks = k * sc
    dq = torch.empty_like(q)
    dv = torch.empty_like(q)
    dk = torch.empty_like(q)
    chunks = []
    # the chunk-local pass: every chunk on its own
    for c in range(-(-S // L)):
        t0, t1 = c * L, min(c * L + L, S)
        sl = slice(t0, t1)
        LF = torch.cumsum(lf[..., sl], -1)
        m = m_all[..., sl]
        Dlog = LF[..., :, None] - LF[..., None, :] + m[..., None, :] \
            - m[..., :, None]                    # D[u, s], s <= u
        lower = torch.tril(torch.ones(t1 - t0, t1 - t0, dtype=torch.bool))
        D = torch.where(lower, torch.exp(torch.where(lower, Dlog, 0.0)), 0.0)
        zeta = torch.exp(LF + m_prev[..., t0, None] - m)         # D(t, t0 - 1)
        rho = torch.exp(LF[..., -1:] - LF + m - m[..., -1:])     # D(t1 - 1, t)
        E = zeta[..., -1]
        DN, Q, K, V = dnum[:, :, sl], q[:, :, sl], ks[:, :, sl], v[:, :, sl]
        P = DN @ V.transpose(-1, -2)             # dnum_u . v_s
        Qk = Q @ K.transpose(-1, -2)             # q_u . ks_s
        snp = snap[:, :, c]
        DNS = DN @ snp                           # rows: C_snap^T dnum_t
        iec, ddc = ie[..., sl], dd[..., sl]
        dq[:, :, sl] = zeta[..., None] * DNS + (D * iec[..., None, :] * P) @ K \
            + ddc[..., None] * n_all[:, :, sl]
        beta = (DNS * Q).sum(-1)
        DT = D.transpose(-1, -2)                 # DT[t, u] = D[u, t]
        dv[:, :, sl] = (iec[..., :, None] * DT * Qk.transpose(-1, -2)) @ DN
        dk[:, :, sl] = (sc * iec[..., :, None] * DT
                        * (P.transpose(-1, -2) + ddc[..., None, :])) @ Q
        N_intra = (DT * ddc[..., None, :]) @ Q
        nu_intra = (N_intra * n_prev[:, :, sl]).sum(-1)
        M = D * iec[..., None, :] * P * Qk       # M[u, s], s <= u
        n_loc = t1 - t0
        w34 = torch.stack([
            (zeta[..., t:] * beta[..., t:]).sum(-1) + M[..., t:, :t].sum((-1, -2))
            for t in range(n_loc)], dim=-1)
        chunks.append(dict(sl=sl, zeta=zeta, rho=rho, E=E, snp=snp, w34=w34,
                           nu_intra=nu_intra))
    # the reverse walk over the chunks, G and N carried at the boundaries,
    # and the gates chunk by chunk
    G = torch.zeros_like(C0)
    N = torch.zeros_like(n0)
    gm = torch.zeros_like(m0)
    di = torch.empty_like(ip)
    df = torch.empty_like(fp)
    for ch in reversed(chunks):
        sl, zeta, rho, E = ch["sl"], ch["zeta"], ch["rho"], ch["E"]
        iec, ddc = ie[..., sl], dd[..., sl]
        out0 = ks[:, :, sl] @ G.transpose(-1, -2)        # G ks_t
        dv[:, :, sl] += (iec * rho)[..., None] * out0
        alpha = (v[:, :, sl] * out0).sum(-1)
        gamma = (G * ch["snp"]).sum((-1, -2))
        out1 = v[:, :, sl] @ G                           # G^T v_t
        dk[:, :, sl] += sc * (iec * rho)[..., None] * (out1 + N[:, :, None])
        kappa = (k[:, :, sl] * dk[:, :, sl]).sum(-1)
        nu_b = (N[:, :, None] * n_prev[:, :, sl]).sum(-1)
        G = E[..., None, None] * G + dnum[:, :, sl].transpose(-1, -2) \
            @ (zeta[..., None] * q[:, :, sl])
        N = E[..., None] * N + ((zeta * ddc)[..., None] * q[:, :, sl]).sum(2)
        # W exact: the anchor, the boundary terms before t, the chunk's own
        a = rho * iec * alpha
        before = torch.cumsum(a, -1) - a
        W = E[..., None] * gamma[..., None] + before + ch["w34"]
        e1 = W + fe[..., sl] * (rho * nu_b + ch["nu_intra"])
        e2 = kappa
        aac, ipc = aa[..., sl], ip[..., sl]
        for t in reversed(range(e1.shape[-1])):
            dm = gm - e1[..., t] - e2[..., t]
            w = torch.where(aac[..., t] > ipc[..., t], 1.0,
                            torch.where(aac[..., t] < ipc[..., t], 0.0, 0.5))
            da = e1[..., t] + w * dm
            di[..., sl.start + t] = e2[..., t] + (1.0 - w) * dm
            df[..., sl.start + t] = da * torch.sigmoid(-fp[..., sl.start + t])
            gm = da
    back = lambda t: t.movedim(2, 1)
    return (back(dq), back(dk), back(dv), di.movedim(2, 1), df.movedim(2, 1),
            G, N, gm)


def _inputs(rng, s, hd, state, small_d=False):
    r = lambda *shape: torch.as_tensor(rng.normal(size=shape))
    ins = [r(B, s, H, hd), r(B, s, H, hd), r(B, s, H, hd),
           3.0 * r(B, s, H), 3.0 * r(B, s, H) + 1.0]
    if small_d:                    # |d_t| < 1 at every other position
        ins[0][:, ::2] *= 0.02
    ins += [r(B, H, hd, hd), r(B, H, hd), r(B, H)] if state else \
        [torch.zeros(B, H, hd, hd, **F), torch.zeros(B, H, hd, **F),
         torch.zeros(B, H, **F)]
    return ins


def _with_ties(ins, at):
    """i_pre set, position by position, to a_t = log sigmoid(f_t) + m_{t-1}
    as the stepped cell computes it: torch.maximum's tie."""
    ins = list(ins)
    ip = ins[3].clone()
    for t in at:
        m_prev = ins[7] if t == 0 else MS._stepped(*ins[:3], ip, *ins[4:])[2][:, t - 1]
        ip[:, t] = _log_sigmoid(ins[4][:, t]) + m_prev
        ins[3] = ip
    return ins


def _check(ins, seed):
    saved = MS._fwd_cpu(*ins)
    dh = torch.as_tensor(np.random.default_rng(seed).normal(
        size=tuple(saved[0].shape)))
    xs = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(MS.mlstm_scan_plain(*xs), xs, dh)
    got = chunked_backward(dh, *ins, *saved)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F64)
    return saved


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("hd", [8, 40])
@pytest.mark.parametrize("s", [1, 32, 100])
def test_chunked_backward_matches_autograd(s, hd, state):
    _check(_inputs(np.random.default_rng(s * 100 + hd + state), s, hd, state),
           s + hd)


def test_chunked_backward_splits_the_max_at_a_tie():
    ins = _with_ties(_inputs(np.random.default_rng(11), 70, 8, True),
                     (0, 5, 31, 32, 64))
    m_all = MS._stepped(*ins)[2]
    m_prev = torch.cat([ins[7][:, None], m_all[:, :-1]], dim=1)
    # a position at a time, as the cell computes it
    ties = sum(int((_log_sigmoid(ins[4][:, t]) + m_prev[:, t]
                    == ins[3][:, t]).sum()) for t in range(70))
    assert ties >= 5 * B * H
    _check(ins, 12)


def test_chunked_backward_where_d_is_below_one():
    ins = _inputs(np.random.default_rng(13), 70, 8, True, small_d=True)
    saved = _check(ins, 14)
    d = saved[3].abs()
    assert bool((d < 1).any()) and bool((d >= 1).any())


def test_chunked_backward_matches_jax_grad():
    rng = np.random.default_rng(15)
    ins = _inputs(rng, 40, 8, True)
    dh = rng.normal(size=(B, 40, H, 8))

    def scan(q, k, v, i_pre, f_pre, c0, n0, m0):
        xs = tuple(jnp.moveaxis(t, 1, 0) for t in (q, k, v, i_pre, f_pre))
        _, hs = jax.lax.scan(JR._mlstm_cell, (c0, n0, m0), xs)
        return jnp.moveaxis(hs, 0, 1)

    with jax.enable_x64(True):
        _, vjp = jax.vjp(scan, *(jnp.asarray(t.numpy()) for t in ins))
        want = vjp(jnp.asarray(dh))
    got = chunked_backward(torch.as_tensor(dh), *ins, *MS._fwd_cpu(*ins))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
