"""The encoder's FLOP and byte counts against numbers worked by hand for
one MiniLM-L-6 pair of 64 tokens."""
from perfbench.metrics.flops import call_bytes, pair_flops, weight_bytes

MINILM = {"num_hidden_layers": 6, "hidden_size": 384,
          "num_attention_heads": 12, "intermediate_size": 1536}


def test_pair_flops_by_hand():
    # per layer: QKV 2*64*384*1152 = 56,623,104; scores and values
    # 2 * 2*64*64*384 = 6,291,456; output 2*64*384*384 = 18,874,368;
    # feed-forward 4*64*384*1536 = 150,994,944; sum 232,783,872.
    # Six layers and the head's 2*384.
    assert pair_flops(MINILM, [64])[0] == 6 * 232_783_872 + 768


def test_flops_grow_with_length_not_padding():
    a, b = pair_flops(MINILM, [32, 64])
    assert b > 2 * a            # attention's n**2
    assert pair_flops(MINILM, [0])[0] == 768


def test_weight_bytes_by_hand():
    # per layer 4*384*384 + 2*384*1536 + 2*384 = 1,770,240 floats;
    # six layers, the final norm and the head: 10,622,208 floats
    assert weight_bytes(MINILM) == 4 * 10_622_208


def test_call_bytes_by_hand():
    # weights 42,488,832; embedding rows and ids 64*(2*384*4 + 4) =
    # 196,864; activations per layer 4*64*384 + 4*64*384 + 2*12*64*64 +
    # 2*64*1536 = 491,520 floats, written and read: 6*491,520*2*4
    assert call_bytes(MINILM, [64]) == 42_488_832 + 196_864 + 23_592_960


def test_call_bytes_reads_weights_once_per_call():
    one = call_bytes(MINILM, [64])
    two = call_bytes(MINILM, [64, 64])
    assert two - one == one - weight_bytes(MINILM)
    assert call_bytes(MINILM, []) == 0.0
