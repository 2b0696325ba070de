"""The correctness check of a served model: a sample of the requests the
window finished, drawn from the seed with the longest among them, run
through the plain reference over its prompt and served tokens.  At each
served position the gap is the reference's best logit less the logit of
the token served there (0 where the reference would serve it too).  The
reference is the configuration's module (``harness.reference_module``),
which the caller passes in."""
from __future__ import annotations

import numpy as np
import torch


def sample(finished: list, k: int, seed: int) -> list:
    """The longest finished request (prompt and answer) and up to k - 1
    others drawn from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (r.prompt_len + len(r.tokens),
                                           -r.k))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng([seed % 2 ** 64, 4])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def reference_logits(ref, params, arch: dict, reqs: list, precision="f32"):
    """[served tokens, vocab] logits, by the reference module ``ref``, of
    each request at the positions its tokens were served from: the
    prompt's last and every served one but the last."""
    dev = params["embed"].device
    seqs = [torch.from_numpy(np.concatenate(
        [r.prompt, np.asarray(r.tokens[:-1], np.int32)])).to(dev)
        for r in reqs]
    pos = [range(r.prompt_len - 1, r.prompt_len + len(r.tokens) - 1)
           for r in reqs]
    return ref.logits_at(params, arch, seqs, [list(p) for p in pos],
                         precision)


def gaps(logits, chosen) -> np.ndarray:
    """The reference's best logit less its logit of each chosen token
    (``logits`` [n, V], ``chosen`` n token ids)."""
    chosen = torch.as_tensor(np.asarray(chosen), device=logits.device).long()
    g = logits.max(-1).values - logits.gather(-1, chosen[:, None])[:, 0]
    return g.cpu().numpy()


def served_gaps(ref, params, arch: dict, reqs: list) -> list:
    """Each sampled request's gaps at its served tokens, by the reference
    module ``ref``."""
    return [gaps(lg, r.tokens) for r, lg in
            zip(reqs, reference_logits(ref, params, arch, reqs))]


def verdict(limits: dict, mean_gap: float | None, failed: int,
            checked: int, off_top: float | None = None
            ) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit", "pass"}}) of the numbers
    compared: the mean gap over the sample's served tokens, where the
    cell's limits name it the share of those tokens that are not the
    reference's best (``off_top_share``), and the failed requests at most
    their limits, the requests checked at least theirs."""
    checks = {
        "mean_gap": {"value": mean_gap,
                     "limit": limits["mean_gap"]["limit"],
                     "pass": "at most"},
        "failed_requests": {"value": failed, "limit": 0,
                            "pass": "at most"},
        "checked_requests": {"value": checked, "limit": 1,
                             "pass": "at least"},
    }
    if "off_top_share" in limits:
        checks["off_top_share"] = {
            "value": off_top, "limit": limits["off_top_share"]["limit"],
            "pass": "at most"}
    ok = all(c["value"] is not None and (
        c["value"] <= c["limit"] if c["pass"] == "at most"
        else c["value"] >= c["limit"]) for c in checks.values())
    return ok, checks
