"""The decoder-only transformer families (``dense``, ``moe``, ``vlm``) as the
benchmark counts them: the parameter tree it draws (names and shapes as the
program's ``Model(params=)`` takes them, with the law of each leaf), the
model FLOPs of one ``generate`` call, and the operations and bytes of one
prefill attention launch.

``a`` is a configuration's ``as_run`` object (the program's ``ModelConfig``
fields); ``config`` the whole configuration file.
"""

from __future__ import annotations


def _dims(a: dict) -> tuple[int, int, int, int, int]:
    hd = a.get("head_dim") or a["d_model"] // a["n_heads"]
    return a["n_layers"], a["d_model"], a["n_heads"], a["n_kv_heads"], hd


def param_shapes(config: dict) -> dict:
    """The parameter tree as (shape, standard deviation) leaves.

    Products are drawn N(0, 1 / fan_in), so each keeps its input's scale;
    the embedding N(0, 0.02^2); the norms' scales (applied as 1 + scale)
    and the q/k/v biases N(0, 0.1^2). A MoE's down projections carry the
    published ``routed_scaling_factor`` (the program applies none, so the
    factor is folded into the draw: the layer's output is the same)."""
    a = config["as_run"]
    L, D, H, K, hd = _dims(a)
    V, F = a["vocab"], a["d_ff"]
    attn = {"wq": ((L, D, H, hd), D ** -0.5), "wk": ((L, D, K, hd), D ** -0.5),
            "wv": ((L, D, K, hd), D ** -0.5), "wo": ((L, H, hd, D), (H * hd) ** -0.5)}
    if a.get("qkv_bias"):
        attn.update(bq=((L, H, hd), 0.1), bk=((L, K, hd), 0.1), bv=((L, K, hd), 0.1))
    blocks: dict = {"ln1": ((L, D), 0.1), "ln2": ((L, D), 0.1), "attn": attn}
    if a["family"] == "moe":
        E = a["moe"]["n_experts"]
        scale = float(config.get("routed_scaling_factor", 1.0))
        blocks["moe"] = {"router": ((L, D, E), D ** -0.5),
                         "w_gate": ((L, E, D, F), D ** -0.5), "w_up": ((L, E, D, F), D ** -0.5),
                         "w_down": ((L, E, F, D), scale * F ** -0.5)}
    else:
        blocks["mlp"] = {"w_gate": ((L, D, F), D ** -0.5), "w_up": ((L, D, F), D ** -0.5),
                         "w_down": ((L, F, D), F ** -0.5)}
    tree = {"embed": ((V, D), 0.02), "final_ln": ((D,), 0.1), "blocks": blocks}
    if not a.get("tie_embeddings"):
        tree["lm_head"] = ((D, V), D ** -0.5)
    return tree


def layer_flops_per_token(a: dict) -> int:
    """2 x the parameters of one layer's products that a token goes through:
    the attention projections, and the MLP or the router and the top-k
    routed experts (not every expert)."""
    _, D, H, K, hd = _dims(a)
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    if a["family"] == "moe":
        E, k = a["moe"]["n_experts"], a["moe"]["top_k"]
        ffn = D * E + k * 3 * D * a["d_ff"]
    else:
        ffn = 3 * D * a["d_ff"]
    return 2 * (attn + ffn)


def call_flops(a: dict, batch: int, prompt: int, new: int) -> int:
    """Model FLOPs of one ``generate`` call: ``batch`` rows of ``prompt``
    positions prefilled, then ``new - 1`` decode steps. Every position
    passes the layers' products; the causal scores and values take
    4 * H * hd FLOPs a visible (query, key) pair a layer; the head runs
    once a generated token (the prompt's last position, then each decode
    step), which is all a user needs."""
    L, D, H, _, hd = _dims(a)
    tokens = prompt + new - 1
    pairs = prompt * (prompt + 1) // 2  # causal prefill
    pairs += sum(p + 1 for p in range(prompt, prompt + new - 1))  # decode at p sees p + 1 keys
    per_row = L * (layer_flops_per_token(a) * tokens + 4 * H * hd * pairs)
    per_row += 2 * D * a["vocab"] * new
    return batch * per_row


def attention_launch(a: dict, batch: int, prompt: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's causal prefill attention over
    ``batch`` x ``prompt`` positions in bf16: 4 * hd FLOPs a visible
    (query, key) pair a query head; q, k, v read and the output written
    once each."""
    _, _, H, K, hd = _dims(a)
    ops = 4 * batch * H * hd * prompt * (prompt + 1) // 2
    n_bytes = 2 * (2 * batch * prompt * H * hd + 2 * batch * prompt * K * hd)
    return ops, n_bytes
