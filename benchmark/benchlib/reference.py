"""The plain reference: one multires pass of OptimalTextures synthesis in
plain PyTorch, for the harness's comparison (``compare.py``).

It follows the published algorithm (JCBrouwer/OptimalTextures
``optex.py``: per pass, for each VGG depth from the deepest, encode, PCA
projection, sliced-OT steps toward the style's statistics, unprojection,
decode) with nothing of the program: its own copy of the VGG-19 tables,
the weights read from the repository's ``weights/*.npz``, ``F.conv2d``,
torch's antialiased bicubic resize (as the published code resizes),
the style prep and PCA widths worked out from the exemplar, the OT as its
definition reads (every step takes the moments or histograms of the cloud
as it is, with no composition), and the rotations drawn again from the
run key by the program's published rule (a ``torch.Generator`` seeded by
``SeedSequence([run_key, pass, stage])``, a Gaussian stack, its polar
factor by 30 Newton-Schulz steps, the sign fix). It imports nothing of
``optimaltextures_tpu_torch`` and nothing of JAX.

Precision (:class:`Precision`): ``float32`` computes convs and matmuls in
full float32 (TF32 off); ``bfloat16`` runs the convs on bfloat16 operands
and activations (conv, then the bias, each rounded) while the statistics,
the PCA and the OT stay float32, as the configuration states. The
controls round operands one step below what the configuration states:
``tf32`` (10-bit mantissas on every conv and matmul operand), with its two
halves ``tf32_conv`` (the convs alone) and ``tf32_mm`` (the statistics,
projections and OT matmuls alone); ``fp8`` (e4m3 conv operands) and
``bf16_tf32`` (bfloat16 convs, the float32 statistics and OT matmuls on
TF32 operands). A control runs on the configured reference's PCA bases,
so that precision is its only difference."""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import schedule

# (cin, cout, k, pre, post) of the normalised VGG-19 encoder up to relu3_1
# and its feature inverter from relu3_1 (published widths 64/128/256)
_ENCODER = [(3, 3, 1, "", ""), (3, 64, 3, "", "relu"),
            (64, 64, 3, "", "relu"), (64, 128, 3, "pool", "relu"),
            (128, 128, 3, "", "relu"), (128, 256, 3, "pool", "relu")]
_DECODER = [(256, 128, 3, "", "relu"), (128, 128, 3, "up", "relu"),
            (128, 64, 3, "", "relu"), (64, 64, 3, "up", "relu"),
            (64, 3, 3, "", "")]
_ENC_LEN = {1: 2, 2: 4, 3: 6}
_DEC_LEN = {1: 1, 2: 3, 3: 5}
POLAR_ITERS = 30
BINS = 256
EPS = 1.0


def encoder_specs(depth: int):
    return _ENCODER[:_ENC_LEN[depth]]


def decoder_specs(depth: int):
    return _DECODER[len(_DECODER) - _DEC_LEN[depth]:]


# ---------------------------------------------------------------- precision

def _identity(x):
    return x


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (TF32)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """-> the nearest float8 e4m3 value (saturating), in x's dtype."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)


class Precision(NamedTuple):
    name: str
    conv_dtype: torch.dtype
    round_conv: Callable
    round_mm: Callable


PRECISIONS = {
    "float32": Precision("float32", torch.float32, _identity, _identity),
    "bfloat16": Precision("bfloat16", torch.bfloat16, _identity, _identity),
    "tf32": Precision("tf32", torch.float32, round_tf32, round_tf32),
    "tf32_conv": Precision("tf32_conv", torch.float32, round_tf32, _identity),
    "tf32_mm": Precision("tf32_mm", torch.float32, _identity, round_tf32),
    "fp8": Precision("fp8", torch.bfloat16, round_fp8, _identity),
    "bf16_tf32": Precision("bf16_tf32", torch.bfloat16, _identity,
                           round_tf32),
}
# the controls of each configured precision: the nearest one below, first,
# then each lowered part alone
CONTROLS = {"float32": ("tf32", "tf32_conv", "tf32_mm"),
            "bfloat16": ("fp8", "bf16_tf32")}


def full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ weights

class Bank(NamedTuple):
    enc: dict      # depth -> [(w OIHW, b)]
    dec: dict


def load_bank(weights_dir: str, depth: int, dtype, device) -> Bank:
    """The encoder and decoder of every depth 1..``depth`` from the npz
    archives (HWIO float32 weights), as (OIHW weight, bias) in ``dtype``."""
    def load(name, specs):
        with np.load(os.path.join(weights_dir, name)) as z:
            n = int(z["num_convs"])
            if n != len(specs):
                raise ValueError(f"{name}: {n} convs, expected {len(specs)}")
            out = []
            for i, (cin, cout, k, _, _) in enumerate(specs):
                w = z[f"conv{i}_w"].astype(np.float32)
                if w.shape != (k, k, cin, cout):
                    raise ValueError(f"{name} conv{i}: shape {w.shape}")
                out.append((torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
                            .to(device, dtype),
                            torch.from_numpy(z[f"conv{i}_b"].astype(
                                np.float32)).to(device, dtype)))
            return out
    return Bank({d: load(f"vgg_normalised_conv{d}_1.npz", encoder_specs(d))
                 for d in range(1, depth + 1)},
                {d: load(f"feature_invertor_conv{d}_1.npz", decoder_specs(d))
                 for d in range(1, depth + 1)})


# -------------------------------------------------------------- conv stacks

def _stack(params, specs, x: torch.Tensor, prec: Precision,
           taps: Optional[set] = None):
    """NCHW ``x`` in the conv dtype through the convs; with ``taps`` the
    outputs after those conv indices are returned as a list."""
    out = []
    for i, ((w, b), (_, _, k, pre, post)) in enumerate(zip(params, specs)):
        if pre == "pool":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        elif pre == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if k == 3:
            x = F.pad(x, (1, 1, 1, 1), mode="reflect")
        xr, wr = prec.round_conv(x), prec.round_conv(w)
        # float32 fuses the bias; bfloat16 rounds the conv, then adds it
        x = (F.conv2d(xr, wr, b) if x.dtype == torch.float32
             else F.conv2d(xr, wr) + b[:, None, None])
        if post == "relu":
            x = torch.relu(x)
        if taps is not None and i in taps:
            out.append(x)
    return out if taps is not None else x


def _chunked(fn, x: torch.Tensor, rows: int):
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def encode(bank: Bank, depth: int, px: torch.Tensor, prec: Precision,
           rows: int = 16) -> torch.Tensor:
    """NHWC float32 pixels -> NHWC float32 relu{depth}_1 features."""
    def one(x):
        x = x.permute(0, 3, 1, 2).to(prec.conv_dtype)
        return _stack(bank.enc[depth], encoder_specs(depth), x, prec
                      ).float().permute(0, 2, 3, 1)
    return _chunked(one, px, rows)


def decode(bank: Bank, depth: int, feat: torch.Tensor, prec: Precision,
           rows: int = 16) -> torch.Tensor:
    """NHWC float32 relu{depth}_1 features -> NHWC float32 pixels."""
    def one(f):
        f = f.permute(0, 3, 1, 2).to(prec.conv_dtype)
        return _stack(bank.dec[depth], decoder_specs(depth), f, prec
                      ).float().permute(0, 2, 3, 1)
    return _chunked(one, feat, rows)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
                    np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a,
                             0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of torch's antialiased bicubic resize
    (``F.interpolate(mode="bicubic", antialias=True)``, the published
    code's resize): Keys' cubic at a = -0.5 stretched by the scale when
    shrinking, taps cut at the border and renormalised; built in float64."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_in / n_out
    support = 2.0 * scale if scale > 1.0 else 2.0
    inv = 1.0 / scale if scale > 1.0 else 1.0
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        j = np.arange(max(0, int(center - support + 0.5)),
                      min(n_in, int(center + support + 0.5)))
        taps = _cubic((j - center + 0.5) * inv)
        total = taps.sum()
        w[o, j] = taps / total if total != 0.0 else taps
    return w.astype(np.float32)


def resize(px: torch.Tensor, hw) -> torch.Tensor:
    """NHWC float32 -> ``hw``: the separable antialiased bicubic resize as
    two contractions, rows first."""
    if tuple(px.shape[1:3]) == tuple(hw):
        return px
    wh = torch.from_numpy(resize_matrix(px.shape[1], hw[0])).to(px.device)
    ww = torch.from_numpy(resize_matrix(px.shape[2], hw[1])).to(px.device)
    y = torch.einsum("oh,nhwc->nowc", wh, px)
    return torch.einsum("ow,nhwc->nhoc", ww, y)


# ---------------------------------------------------------------- style prep

class Target(NamedTuple):
    eigvecs: torch.Tensor      # (C, k)
    mu: torch.Tensor           # (1, 1, 1, k)
    cov: torch.Tensor          # (k, k)
    samples: torch.Tensor      # (Ns, k)


def style_prep(bank: Bank, depth: int, style: torch.Tensor, prec: Precision,
               bases: Optional[List[torch.Tensor]] = None,
               signs_from: Optional[List[Optional[torch.Tensor]]] = None
               ) -> List[Target]:
    """One pass's targets, deepest depth first: one forward of the
    depth-``depth`` encoder with a tap at every relu{d}_1, each tap's PCA
    (scalar-mean centred Gram, its eigenvectors by descending eigenvalue,
    the first k by the 90% rule) and the projected style's moments and
    samples.

    ``bases`` (deepest first) replaces the PCA by given (C, k) bases: a
    control runs on the configured reference's. ``signs_from`` (deepest
    first, None where absent) gives each eigenvector the sign of the same
    column of another basis: an eigenvector's sign is the solver's choice,
    not a property of the style, and the comparison takes the program's
    (``compare.py``)."""
    x = style.permute(0, 3, 1, 2).to(prec.conv_dtype)
    taps = _stack(bank.enc[depth], encoder_specs(depth), x, prec,
                  taps={_ENC_LEN[d] - 1 for d in range(1, depth + 1)})
    out = []
    for i, d in enumerate(range(depth, 0, -1)):
        sf = taps[d - 1].float().permute(0, 2, 3, 1).contiguous()
        c = sf.shape[-1]
        if bases is not None:
            v = bases[i]
        else:
            xc = prec.round_mm(sf.reshape(-1, c) - sf.mean())
            eva, eve = torch.linalg.eigh(xc.T @ xc)
            svals = torch.sqrt(torch.clamp(eva.flip(0), min=0.0))
            k = schedule.choose_k(svals.double().cpu().numpy())
            v = eve.flip(1)[:, :k].contiguous()
            if signs_from is not None and signs_from[i] is not None:
                v = align_signs(v, signs_from[i])
        k = v.shape[1]
        sp = prec.round_mm(sf) @ prec.round_mm(v)
        mu = sp.mean(dim=(1, 2), keepdim=True)
        spc = prec.round_mm((sp - mu).reshape(-1, k))
        out.append(Target(v, mu, spc.T @ spc / spc.shape[0],
                          sp.reshape(-1, k)))
    return out


def align_signs(v: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``v`` (C, k) with each column's sign flipped where its dot product
    with the same column of ``other`` (C, k') is negative (the columns
    both have)."""
    n = min(v.shape[1], other.shape[1])
    if other.shape[0] != v.shape[0] or n == 0:
        return v
    dots = (v[:, :n] * other[:, :n].to(v)).sum(0)
    signs = torch.ones(v.shape[1], dtype=v.dtype, device=v.device)
    signs[:n] = torch.where(dots < 0, -1.0, 1.0)
    return v * signs


def pass_widths(targets: List[Target]) -> List[int]:
    return [t.eigvecs.shape[1] for t in targets]


# ---------------------------------------------------------------- rotations

def derive_seed(*parts: int) -> int:
    ss = np.random.SeedSequence([int(p) % (2 ** 64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def stage_rotations(run_key: int, pass_idx: int, stage: int, n: int, k: int,
                    device) -> torch.Tensor:
    """(n, k, k) SO(k) rotations of one stage: the polar factor of a
    Gaussian stack (Newton-Schulz from the Frobenius-scaled matrix), the
    last column flipped where det < 0."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(run_key, pass_idx, stage))
    gs = torch.randn((n, k, k), generator=g, device=device,
                     dtype=torch.float32)
    x = gs / torch.sqrt(torch.sum(gs * gs, dim=(1, 2), keepdim=True))
    for _ in range(POLAR_ITERS):
        x = 1.5 * x - 0.5 * torch.matmul(torch.matmul(x, x.transpose(1, 2)), x)
    sign, _ = torch.linalg.slogdet(gs)
    x = x.clone()
    x[:, :, -1] *= sign[:, None]
    return x


# --------------------------------------------------------------- transport

def chol_step(f: torch.Tensor, rot: torch.Tensor, tgt: Target,
              prec: Precision) -> torch.Tensor:
    """One moment step in the rotated basis: the cloud's per-image means and
    pooled covariance, A = L_s L_t^-1 from the ridged Cholesky factors, and
    f -> (f - mu_t) R A^T R^T + mu_s."""
    k = f.shape[-1]
    mu = f.mean(dim=(1, 2), keepdim=True)
    xc = prec.round_mm((f - mu).reshape(-1, k))
    cov_t = xc.T @ xc / xc.shape[0]
    eye = torch.eye(k, device=f.device)
    lt = torch.linalg.cholesky(rot.T @ cov_t @ rot + EPS * eye)
    ls = torch.linalg.cholesky(rot.T @ tgt.cov @ rot + EPS * eye)
    a = torch.linalg.solve_triangular(lt, ls, upper=False, left=False)
    m = rot @ a.T @ rot.T
    return (xc @ prec.round_mm(m)).reshape(f.shape) + tgt.mu


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """Row-wise interp of the published code: the first node with xp >= x,
    a linear map on [idx, idx + 1], falling back to the map anchored at
    idx + 1 and then to fp[idx] where the slope is not finite."""
    n = xp.shape[1]
    idx = torch.searchsorted(xp.contiguous(), x.contiguous()).clamp(max=n - 1)
    nxt = (idx + 1).clamp(max=n - 1)
    xi, xn = torch.gather(xp, 1, idx), torch.gather(xp, 1, nxt)
    fi, fn = torch.gather(fp, 1, idx), torch.gather(fp, 1, nxt)
    slope = (fn - fi) / (xn - xi)
    f0 = slope * (x - xi) + fi
    f1 = slope * (x - xn) + fn
    return torch.where(torch.isfinite(f0), f0,
                       torch.where(torch.isfinite(f1), f1, fi))


def _histc(rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
           ) -> torch.Tensor:
    """(C, N) -> (C, BINS) counts with torch.histc's binning on [lo, hi]."""
    c = rows.shape[0]
    width = hi - lo
    width = torch.where(width > 0, width, torch.ones_like(width))
    idx = ((rows - lo[:, None]) * BINS / width[:, None]).to(torch.int64)
    idx = idx.clamp(0, BINS - 1) + BINS * torch.arange(c, device=rows.device
                                                       )[:, None]
    return torch.bincount(idx.reshape(-1), minlength=c * BINS
                          ).reshape(c, BINS).float()


def cdf_match_rows(t: torch.Tensor, s: torch.Tensor,
                   block: int = 1 << 27) -> torch.Tensor:
    """Each row of ``t`` (C, N) mapped onto the distribution of the same row
    of ``s``: 256-bin histograms on the rows' shared range, their CDFs, the
    remap table interp(t_cdf; s_cdf -> right edges), then interp(t; right
    edges -> table). Rows in blocks of about ``block`` samples."""
    out = torch.empty_like(t)
    step = max(1, block // t.shape[1])
    for c0 in range(0, t.shape[0], step):
        tr, sr = t[c0:c0 + step], s[c0:c0 + step]
        lo = torch.minimum(tr.amin(1), sr.amin(1))
        hi = torch.maximum(tr.amax(1), sr.amax(1))
        tc = torch.cumsum(_histc(tr, lo, hi), 1)
        sc = torch.cumsum(_histc(sr, lo, hi), 1)
        tc, sc = tc / tc[:, -1:], sc / sc[:, -1:]
        j = torch.arange(1, BINS + 1, device=t.device, dtype=torch.float32)
        edges = lo[:, None] + j * ((hi - lo) / BINS)[:, None]
        out[c0:c0 + step] = _interp(tr, edges, _interp(tc, sc, edges))
    return out


def cdf_step(f: torch.Tensor, rot: torch.Tensor, tgt: Target,
             prec: Precision) -> torch.Tensor:
    """One sliced step of cdf matching: rotate both clouds, match every
    rotated coordinate, rotate back."""
    k = f.shape[-1]
    r = prec.round_mm(rot)
    rf = (prec.round_mm(f.reshape(-1, k)) @ r).T.contiguous()
    rs = (prec.round_mm(tgt.samples) @ r).T.contiguous()
    matched = cdf_match_rows(rf, rs)
    return (prec.round_mm(matched.T) @ r.T).reshape(f.shape)


def transport(f: torch.Tensor, tgt: Target, *, run_key: int, pass_idx: int,
              stage: int, n_iters: int, mode: str, prec: Precision,
              steps: Optional[int] = None) -> torch.Tensor:
    """A stage's ``n_iters`` OT steps (the first ``steps`` of them) on the
    projected NHWC features ``f``, with the stage's rotations drawn again
    from the run key."""
    step = cdf_step if mode == "cdf" else chol_step
    if n_iters:
        rots = stage_rotations(run_key, pass_idx, stage, n_iters,
                               f.shape[-1], f.device)
        for rot in rots[:steps]:
            f = step(f, rot, tgt, prec)
    return f


# -------------------------------------------------------------------- pass

def run_pass(bank: Bank, targets: List[Target], px: torch.Tensor, *,
             size: int, iters, pass_idx: int, run_key: int, mode: str,
             prec: Precision) -> torch.Tensor:
    """One pass from the NHWC float32 pastiche ``px``: the resize to
    ``size`` (unless either dim is there already), then each depth from
    the deepest: encode, project, ``iters[l]`` steps, unproject, decode.
    Returns the NHWC float32 pixels."""
    if px.shape[1] != size and px.shape[2] != size:
        px = resize(px, (size, size))
    depth = len(targets)
    for l, tgt in enumerate(targets):
        d = depth - l
        f = prec.round_mm(encode(bank, d, px, prec)) @ prec.round_mm(
            tgt.eigvecs)
        f = transport(f, tgt, run_key=run_key, pass_idx=pass_idx, stage=l,
                      n_iters=iters[l], mode=mode, prec=prec)
        f = prec.round_mm(f) @ prec.round_mm(tgt.eigvecs.T)
        px = decode(bank, d, f, prec)
    return px


def quantize(px: torch.Tensor) -> torch.Tensor:
    """Pixels -> PNG bytes: clamp to [0, 1], x 255, rounded."""
    return torch.round(torch.clamp(px, 0.0, 1.0) * 255.0).to(torch.uint8)
