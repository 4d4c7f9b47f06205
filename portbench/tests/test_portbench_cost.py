"""The FLOP and byte counts against values worked out by hand."""
from portbench.harness import cost, spec


def model(name):
    return spec.read_json(spec.PORTBENCH / "configs" / f"{name}.json")["model"]


def test_chatglm3_flops_by_hand():
    m = model("chatglm3-6b-7l")
    # a layer's projections: q 4096x4096, k and v 4096x256, o 4096x4096;
    # the MLP 3 x 4096 x 13696
    per_token = 2 * (4096 * 4096 * 2 + 2 * 4096 * 256 + 3 * 4096 * 13696)
    assert cost.layer_matmul_flops_per_token(m) == per_token
    attn = 2 * 4096 * 4096 * 32 * 128
    fwd = 7 * (4096 * per_token + attn) + 2 * 4096 * 4096 * 65024
    assert cost.train_step_flops(m, 4, 4096) == 3 * 4 * fwd
    assert abs(cost.train_step_flops(m, 4, 4096) / 1e12 - 178.07) < 0.01
    full = model("chatglm3-6b")
    assert cost.prefill_flops(full, 4096) == (
        28 * (4096 * per_token + attn) + 2 * 4096 * 65024)


def test_granite_flops_by_hand():
    m = model("granite-moe-3b-a800m")
    # q 1536x(24x64), k, v 1536x(8x64), o (24x64)x1536; router 1536x40;
    # 8 experts of 3 x 1536 x 512
    per_token = 2 * (1536 * 1536 * 2 + 2 * 1536 * 512 + 1536 * 40
                     + 8 * 3 * 1536 * 512)
    assert cost.layer_matmul_flops_per_token(m) == per_token
    attn = 2 * 2048 * 2048 * 24 * 64
    fwd = 16 * (2048 * per_token + attn) + 2 * 2048 * 1536 * 49155
    assert cost.train_step_flops(m, 4, 2048) == 3 * 4 * fwd


def test_fwht_bytes_by_hand():
    # a 28-layer chatglm3 K leaf of a 1,000-token prompt: 28 x 1000 x 2 x
    # 128 = 7,168,000 floats in blocks of 64 (no padding); read and
    # written, coded and decoded
    assert cost.fwht_bytes([7_168_000], 64) == 7_168_000 * 4 * 2 * 2
    # granite's moe.wi leaf, 16 x 48 x 1536 x 512, blocks of 4096
    n = 16 * 48 * 1536 * 512
    assert cost.fwht_bytes([n], 4096) == n * 16
    # a payload that does not fill its block is padded: 5000 -> 8192
    assert cost.fwht_bytes([5000], 4096) == 8192 * 16
    assert cost.rotation_n(1000, 4096) == 512
