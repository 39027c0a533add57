"""Style packs: a style's finished transport targets on disk (the counterpart
of ``optimaltextures_tpu/utils/stylepack.py``).

``Synthesizer.run(styles_token=...)`` keeps every pass's finished style
targets (projected eigenvectors, mu / cov / samples, the scalar mean, the
true-rank masks of padded widths) in memory. A pack writes them to one
``.npz`` so that a restarted server, or another process, skips all style
encode and eigh work and the k-decision fetch on its first request.

The format is the JAX package's, version 2: a JSON ``manifest`` (the config
signature, and per entry ``ck``, ``fingerprint``, ``widths``, ``n_depths``,
``has_eigvecs``, ``has_samples``, ``has_kmask``) beside arrays named
``e{j}_d{i}_{eigvecs,mu,cov,samples,mean,kmask}``. A pack written by either
package loads in the other. Importing into a Synthesizer whose signature
differs raises.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np
import torch


def _signature(synth) -> List:
    cfg = synth.cfg
    return [synth.depth, cfg.hist_mode, cfg.no_pca, cfg.pca_bucket,
            cfg.pca_traced_k, cfg.style_scale, cfg.size, cfg.passes,
            cfg.no_multires, cfg.compat_schedule_quirk]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def export_style_pack(synth, styles_token, path: str) -> str:
    """Write every finished cache entry of ``styles_token`` to ``path``.

    Cache keys are ``((token, fingerprint), ck)``. Each entry's fingerprint
    goes into the manifest, so that an import keys it as a run of the same
    styles would, and entries of a token reused for other styles stay
    apart."""
    entries = [(full, e) for full, e in synth._style_prep_cache.items()
               if full[0][0] == styles_token and e.slim is not None]
    if not entries:
        raise ValueError(
            f"no finished style-prep cache entries for token {styles_token!r}"
            " — run() with styles_token at least once first")

    arrays = {}
    manifest = {"version": 2, "signature": _signature(synth), "entries": []}
    for j, (full, e) in enumerate(entries):
        ent = {"ck": full[1], "fingerprint": full[0][1],
               "widths": [int(w) for w in e.widths],
               "n_depths": len(e.slim),
               "has_eigvecs": [], "has_samples": [], "has_kmask": []}
        for i, (eigvecs, stats, mean) in enumerate(e.slim):
            pre = f"e{j}_d{i}_"
            kmask = e.masks[i]
            ent["has_eigvecs"].append(eigvecs is not None)
            ent["has_samples"].append(stats.samples is not None)
            ent["has_kmask"].append(kmask is not None)
            if eigvecs is not None:
                arrays[pre + "eigvecs"] = _host(eigvecs)
            arrays[pre + "mu"] = _host(stats.mu)
            arrays[pre + "cov"] = _host(stats.cov_raw)
            if stats.samples is not None:
                arrays[pre + "samples"] = _host(stats.samples)
            arrays[pre + "mean"] = _host(mean)
            if kmask is not None:
                arrays[pre + "kmask"] = _host(kmask)
        manifest["entries"].append(ent)

    np.savez(path, manifest=np.asarray(json.dumps(manifest)), **arrays)
    return path


def import_style_pack(synth, styles_token, path: str) -> int:
    """Load a pack into ``synth``'s cross-run cache under ``styles_token``,
    on ``synth.device``. Returns the number of entries restored. Raises on a
    version or signature mismatch."""
    from .. import transport
    from ..core import _StylePrep

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if manifest.get("version") != 2:
            raise ValueError(f"style pack version {manifest.get('version')} "
                             "unsupported (expected 2)")
        if manifest["signature"] != _signature(synth):
            raise ValueError(
                f"style pack signature {manifest['signature']} does not match "
                f"this Synthesizer's {_signature(synth)}")

        for j, ent in enumerate(manifest["entries"]):
            pre = f"e{j}_d"

            def load(i, name, present=True):
                if not present:
                    return None
                return torch.from_numpy(z[f"{pre}{i}_{name}"]).to(synth.device)

            slim, masks = [], []
            for i in range(ent["n_depths"]):
                stats = transport.StyleStats(
                    load(i, "mu"), load(i, "cov"),
                    load(i, "samples", ent["has_samples"][i]))
                slim.append((load(i, "eigvecs", ent["has_eigvecs"][i]), stats,
                             load(i, "mean")))
                masks.append(load(i, "kmask", ent["has_kmask"][i]))
            full = ((styles_token, ent["fingerprint"]), ent["ck"])
            synth._style_prep_cache[full] = _StylePrep(
                None, full, widths=tuple(ent["widths"]), masks=tuple(masks),
                slim=slim)
    synth._evict_style_preps()
    return len(manifest["entries"])
