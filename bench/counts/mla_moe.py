"""Latent attention with a DeepSeek MoE (Moonlight-16B-A3B's architecture,
``model_type`` deepseek_v3) as the benchmark counts it: the parameter tree
it draws (names and shapes as the program's ``Model(params=)`` takes them,
with the law of each leaf), the model FLOPs of one ``generate`` call by the
published equations, and the operations and bytes of one latent decode
attention launch.

``a`` is a configuration's ``as_run`` object (the program's ``ModelConfig``
fields); ``config`` the whole configuration file.
"""

from __future__ import annotations

# The correction bias's spread: a trained router's is in its weights, not in
# config.json (the configuration's ``assumed``).
BIAS_STD = 0.05


def _widths(a: dict) -> tuple[int, int, int, int, int]:
    return (a["kv_lora_rank"], a["qk_nope_head_dim"], a["qk_rope_head_dim"], a["v_head_dim"],
            a["first_dense_layers"])


def param_shapes(config: dict) -> dict:
    """The parameter tree as (shape, standard deviation) leaves.

    Products are drawn N(0, 1 / fan_in), so each keeps its input's scale;
    the embedding N(0, 0.02^2); the norms' scales (applied as 1 + scale,
    the latent's norm too) N(0, 0.1^2); the router's correction bias
    N(0, ``BIAS_STD``^2).  The leading dense layers are their own stack,
    ``dense_blocks``; the routed scale is the program's to apply."""
    a = config["as_run"]
    L, D, H, V = a["n_layers"], a["d_model"], a["n_heads"], a["vocab"]
    r, nope, rope, vd, n_dense = _widths(a)
    spec = a["moe"]
    E, F = spec["n_experts"], a["d_ff"]

    def mlp(n: int, f: int) -> dict:
        return {"w_gate": ((n, D, f), D ** -0.5), "w_up": ((n, D, f), D ** -0.5),
                "w_down": ((n, f, D), f ** -0.5)}

    def block(n: int) -> dict:
        return {"ln1": ((n, D), 0.1), "ln2": ((n, D), 0.1), "attn": {
            "wq": ((n, D, H, nope + rope), D ** -0.5), "wkv_a": ((n, D, r + rope), D ** -0.5),
            "kv_norm": ((n, r), 0.1), "wk_b": ((n, r, H, nope), r ** -0.5),
            "wv_b": ((n, r, H, vd), r ** -0.5), "wo": ((n, H, vd, D), (H * vd) ** -0.5)}}

    n_moe = L - n_dense
    moe = {"router": ((n_moe, D, E), D ** -0.5), "w_gate": ((n_moe, E, D, F), D ** -0.5),
           "w_up": ((n_moe, E, D, F), D ** -0.5), "w_down": ((n_moe, E, F, D), F ** -0.5)}
    if spec.get("correction_bias"):
        moe["bias"] = ((n_moe, E), BIAS_STD)
    if spec.get("n_shared"):
        moe["shared"] = mlp(n_moe, spec["n_shared"] * F)
    tree = {"embed": ((V, D), 0.02), "final_ln": ((D,), 0.1), "blocks": {**block(n_moe), "moe": moe}}
    if n_dense:
        tree["dense_blocks"] = {**block(n_dense), "mlp": mlp(n_dense, a["dense_d_ff"])}
    if not a.get("tie_embeddings"):
        tree["lm_head"] = ((D, V), D ** -0.5)
    return tree


def layer_flops_per_token(a: dict, dense: bool) -> int:
    """2 x the parameters of one layer's products that a token goes through,
    in the published (expanded) form: q, kv_a, the expansion of the latent
    into each head's k_nope and v, the output; then the dense MLP, or the
    router, the top-k routed experts (not every expert) and the shared
    experts."""
    D, H = a["d_model"], a["n_heads"]
    r, nope, rope, vd, _ = _widths(a)
    attn = D * H * (nope + rope) + D * (r + rope) + r * H * (nope + vd) + H * vd * D
    if dense:
        ffn = 3 * D * a["dense_d_ff"]
    else:
        spec = a["moe"]
        F = a["d_ff"]
        ffn = D * spec["n_experts"] + (spec["top_k"] + spec.get("n_shared", 0)) * 3 * D * F
    return 2 * (attn + ffn)


def call_flops(a: dict, batch: int, prompt: int, new: int) -> int:
    """Model FLOPs of one ``generate`` call: ``batch`` rows of ``prompt``
    positions prefilled, then ``new - 1`` decode steps.  Every position
    passes the layers' products; a visible (query, key) pair takes
    2 * H * (nope + rope + v) FLOPs a layer (its score and its value); the
    head runs once a generated token."""
    L, H = a["n_layers"], a["n_heads"]
    _, nope, rope, vd, n_dense = _widths(a)
    tokens = prompt + new - 1
    pairs = prompt * (prompt + 1) // 2  # causal prefill
    pairs += sum(p + 1 for p in range(prompt, prompt + new - 1))  # decode at p sees p + 1 keys
    layers = (n_dense * layer_flops_per_token(a, True)
              + (L - n_dense) * layer_flops_per_token(a, False))
    per_row = layers * tokens + L * 2 * H * (nope + rope + vd) * pairs
    per_row += 2 * a["d_model"] * a["vocab"] * new
    return batch * per_row


def mla_decode_launch(a: dict, batch: int, fill: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's latent decode attention over
    ``batch`` rows of ``fill`` cached tokens, in the absorbed form the
    decode runs: 2 * (r + rope + r) FLOPs a (query head, token), its score
    and its latent sum; the live latent and rope rows, q (H x (r + rope) a
    row) and the output (H x r a row) read or written once each, in the
    configuration's type."""
    H = a["n_heads"]
    r, _, rope, _, _ = _widths(a)
    es = {"bfloat16": 2, "float32": 4}[a["dtype"]]
    ops = 2 * batch * H * fill * (2 * r + rope)
    n_bytes = es * batch * (fill * (r + rope) + H * (r + rope) + H * r)
    return ops, n_bytes
