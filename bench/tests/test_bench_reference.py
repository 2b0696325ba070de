"""The plain reference against the port's plain forward at the port's
smoke sizes on the CPU (f32), its scan against the step-by-step
recurrence, and its weight layout against the port's parameter tree."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from bench import counts, weights
from bench.reference import model as ref

MODELS = ["olmoe-1b-7b", "jamba-v0.1-52b"]


def _configs(name):
    from repro_torch.configs import get_config, get_smoke_config
    return get_smoke_config(name), get_config(name)


@pytest.mark.parametrize("name", MODELS)
def test_layout_is_the_ports_tree(name):
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    for cfg in _configs(name):
        port = sc.map_tree(lambda d: (tuple(d.shape), d.dtype),
                           tf.schema(cfg))
        mine = sc.map_tree(lambda leaf: (tuple(leaf[0]), leaf[1]),
                           ref.layout(dataclasses.asdict(cfg)))
        assert port == mine


@pytest.mark.parametrize("name", MODELS)
def test_full_configs_are_the_files(name):
    """The configuration files' arch blocks are the port's own configs."""
    import json
    from pathlib import Path
    body = json.loads((Path(__file__).resolve().parents[1] / "configs"
                       / f"{name}.json").read_text())
    full = dataclasses.asdict(_configs(name)[1])
    for k, v in body["arch"].items():
        if k not in ("n_layers", "pattern"):
            assert full[k] == v, k
    # the layer kinds of one period, where the published offset puts them
    pattern = body["arch"]["pattern"]
    assert sorted(pattern) == sorted(full["pattern"])
    if "attn_layer_offset" in body:
        assert pattern.index("G") == body["attn_layer_offset"]
    assert body["hidden_size"] == body["arch"]["d_model"]
    assert body["num_hidden_layers"] == body["arch"]["n_layers"]
    assert body["vocab_size"] == body["arch"]["vocab"]


@pytest.mark.parametrize("name,pattern", [(m, None) for m in MODELS]
                         + [("jamba-v0.1-52b", "MMMMGMMM")])
def test_reference_matches_the_ports_forward(name, pattern):
    from repro_torch.models import schema as sc
    from repro_torch.models import transformer as tf
    cfg = _configs(name)[0]
    if pattern:                              # the benchmark file's period
        cfg = dataclasses.replace(cfg, pattern=pattern)
    arch = dataclasses.asdict(cfg)
    w = sc.map_tree(lambda t: t.float(),
                    weights.draw(ref.layout(arch), 2 ** 33 + 1, "cpu"))
    T = 192                                  # a multiple of the SSD chunk
    toks = torch.randint(0, cfg.vocab, (T,),
                         generator=torch.Generator().manual_seed(1))
    port = tf.forward(w, cfg, toks[None])[0]
    mine = ref.logits_at(w, arch, [toks], [list(range(T))])[0]
    assert torch.allclose(mine, port, atol=2e-4, rtol=0), \
        (mine - port).abs().max()
    ctl = ref.logits_at(w, arch, [toks], [list(range(T))], "fp8")[0]
    assert (ctl - port).abs().max() > 0.05


def test_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(2)
    T, H, P, N = 300, 3, 4, 5
    x = torch.randn(T, H, P, generator=g)
    dt = F.softplus(torch.randn(T, H, generator=g))
    A = -torch.rand(H, generator=g) - 0.1
    Bm, Cm = torch.randn(T, N, generator=g), torch.randn(T, N, generator=g)
    h = torch.zeros(H, P, N)
    want = []
    for t in range(T):
        h = torch.exp(dt[t] * A)[:, None, None] * h \
            + (dt[t][:, None] * x[t])[..., None] * Bm[t]
        want.append(h @ Cm[t])
    got = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert torch.allclose(got, torch.stack(want), atol=1e-4)


def test_weights_same_seed_same_values():
    arch = dataclasses.asdict(_configs("jamba-v0.1-52b")[0])
    lay = ref.layout(arch)
    a, b = weights.draw(lay, 7, "cpu"), weights.draw(lay, 7, "cpu")
    c = weights.draw(lay, 8, "cpu")
    wa, wb = a["blocks"]["l1"]["ffn"]["w_up"], b["blocks"]["l1"]["ffn"]["w_up"]
    assert torch.equal(wa, wb)
    assert not torch.equal(wa, c["blocks"]["l1"]["ffn"]["w_up"])
    assert wa.dtype == torch.bfloat16
    assert torch.equal(a["blocks"]["l0"]["mamba"]["D"],
                       torch.ones_like(a["blocks"]["l0"]["mamba"]["D"]))
    std = float(a["lm_head"].float().std())
    assert abs(std * arch["d_model"] ** 0.5 - 1) < 0.1
    for path, (shape, dtype, _) in weights.leaves(lay):
        t = a
        for k in path:
            t = t[k]
        assert tuple(t.shape) == shape and t.dtype == dtype


@pytest.mark.parametrize("name", MODELS)
def test_counts_match_the_ports_active_parameters(name):
    cfg = _configs(name)[1]
    arch = dataclasses.asdict(cfg)
    head = 2 * arch["d_model"] * arch["vocab"]      # embedding and head
    assert counts.active_body_params(ref, arch) + head == pytest.approx(
        cfg.active_param_count(), rel=1e-5)
    one = counts.decode_flops(ref, arch, 1, 1000)
    assert counts.decode_flops(ref, arch, 2, 2000) == pytest.approx(2 * one)
    assert counts.prefill_flops(ref, arch, 1) == pytest.approx(one - (
        counts.decode_flops(ref, arch, 1, 1000)
        - counts.decode_flops(ref, arch, 1, 1)))
