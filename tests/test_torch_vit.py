"""ViT port: a tiny DINOv2ViT against the JAX package's on the same weights.

ViTConfig(32, 2, 2) at 56 x 56 (a 4 x 4 grid, 17 tokens) and at 42 x 42 (a
3 x 3 grid, 10 tokens), weights drawn from a seed and carried across by
``io.convert.rename_tree``. The JAX side runs its channels-major stream on
the CPU as its own tests do. The port's channels-major stream is pre-padded
to a multiple of 8 tokens (24 and 16 here; 1 + grid^2 is never a multiple
of 8): the parity test sees that the pad changes no output, and a second
test that junk in the pad lanes never reaches one.

fp32: 1e-4 on the final-norm tokens (two blocks of fp32 matmuls and
softmax in different summation orders, then a LayerNorm that rescales by
1/std). bf16: the two sides round differently inside their bf16 matmuls
and GELUs, and the port adds each dense bias before the bf16 rounding
(``baddbmm``, one rounding) where the JAX package adds it after (two), so
the check is loose: 0.1 on unit-variance outputs (a few bf16 ulps at
|x| ~ 4), and a mean error under 2e-2 (measured 1.1e-2, about 1.4 bf16 ulps
at |x| ~ 1).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multihmr_tpu.config import ViTConfig
from multihmr_tpu.models.vit import DINOv2ViT as JViT
from multihmr_tpu_torch.io.convert import rename_tree
from multihmr_tpu_torch.models.vit import DINOv2ViT as TViT, padded_len

CFG = ViTConfig(embed_dim=32, depth=2, num_heads=2)
GRID = 4


def _random_params(rng, grid=GRID):
    x = jnp.zeros((1, 14 * grid, 14 * grid, 3))
    tree = JViT(CFG, grid_size=grid, dtype=jnp.float32).init(jax.random.PRNGKey(0), x)
    # init leaves are mostly zeros/ones and LayerScale 1e-5: redraw them all
    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "norm" in name and "scale" in name:
            return jnp.asarray(1 + 0.1 * rng.normal(size=a.shape), jnp.float32)
        return jnp.asarray(0.3 * rng.normal(size=a.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _port(params, dtype, grid=GRID):
    sd = rename_tree({"backbone": jax.device_get(params["params"])}, CFG.depth)
    vit = TViT(CFG, grid, dtype)
    vit.load_state_dict({k.removeprefix("backbone."): torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    return vit


@pytest.mark.parametrize("grid", [GRID, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_matches_jax(rng, dtype, grid):
    params = _random_params(rng, grid)
    x = rng.normal(size=(2, 14 * grid, 14 * grid, 3)).astype(np.float32)
    want = jax.jit(JViT(CFG, grid_size=grid, dtype=jnp.dtype(dtype)).apply)(params, x)
    vit = _port(params, getattr(torch, dtype), grid)
    with torch.inference_mode():
        got = vit(torch.from_numpy(x))
    for key in ("patch_tokens", "cls_token"):
        a = np.asarray(want[key], np.float32)
        b = got[key].float().numpy()
        assert got[key].dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=key)
        else:
            np.testing.assert_allclose(b, a, atol=0.1, err_msg=key)
            assert np.abs(b - a).mean() < 2e-2, key


def test_vit_shapes_and_grid_check(rng):
    vit = TViT(CFG, GRID, torch.float32)
    vit.init_weights(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = vit(torch.zeros(1, 56, 56, 3))
        assert out["patch_tokens"].shape == (1, 16, 32)
        assert out["cls_token"].shape == (1, 32)
        with pytest.raises(ValueError, match="grid"):
            vit(torch.zeros(1, 70, 70, 3))


@pytest.mark.parametrize("n_tok,want", [(17, 24), (10, 16), (2305, 2312), (4097, 4104),
                                        (8465, 8472), (16, 16)])
def test_padded_len(n_tok, want):
    assert padded_len(n_tok) == want


@pytest.mark.parametrize("remat_policy", [None, "block"])
def test_pad_lanes_never_reach_outputs(rng, remat_policy):
    """Every block sees the padded stream ([B, D, 24] for 17 tokens) with
    kv_len 17; junk written into the pad lanes before each block changes no
    output bit, forward or gradient (fp32)."""
    params = _random_params(rng)
    x = torch.from_numpy(rng.normal(size=(2, 56, 56, 3)).astype(np.float32))
    junk = torch.from_numpy(1e3 * rng.normal(size=(2, CFG.embed_dim, 7)).astype(np.float32))
    seen, runs = [], {}
    for poison in (False, True):
        vit = _port(params, torch.float32)
        vit.remat_block = remat_policy == "block"

        def pre(module, args, poison=poison):
            tokens, kv_len = args
            seen.append((tuple(tokens.shape), kv_len))
            if poison:
                tokens = tokens.clone()
                tokens[..., kv_len:] = junk
            return tokens, kv_len

        for blk in vit.blocks:
            blk.register_forward_pre_hook(pre)
        out = vit(x)
        (out["patch_tokens"].square().sum() + out["cls_token"].sum()).backward()
        runs[poison] = ([out[k].detach() for k in ("patch_tokens", "cls_token")],
                        {k: p.grad for k, p in vit.named_parameters()})
    assert set(seen) == {((2, CFG.embed_dim, 24), 17)}
    for a, b in zip(runs[False][0], runs[True][0]):
        assert torch.equal(a, b)
    for k, g in runs[False][1].items():
        assert torch.equal(g, runs[True][1][k]), k
