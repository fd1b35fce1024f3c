"""The corpus CLI of the port's ``tokenizer.py`` against the JAX
package's: ``python -m kubedl_tpu_torch.tokenizer --encode`` writes the
JAX command's token file byte for byte, and the port's trainer trains on
it; ``train_tokenizer`` trains the JAX command's BPE vocabulary."""

import json

import numpy as np

from kubedl_tpu import tokenizer as jtok
from kubedl_tpu_torch import tokenizer as ttok

LINES = [f"document {i}: the quick brown fox jumps over {i * 7} lazy dogs"
         for i in range(40)]


def _corpus(tmp_path):
    text = tmp_path / "corpus.txt"
    text.write_text("\n".join(LINES[:30]))
    rows = tmp_path / "corpus.jsonl"
    rows.write_text("\n".join(json.dumps({"text": t}) for t in LINES[30:]))
    return [str(text), str(rows)]


def test_encode_writes_the_jax_token_file_and_the_port_trains_on_it(
        tmp_path, capsys):
    from kubedl_tpu_torch.train import __main__ as tmain
    paths = _corpus(tmp_path)
    want, got = tmp_path / "jax.bin", tmp_path / "port.bin"
    assert jtok.main(["--encode", "byte", *paths, str(want)]) == 0
    assert ttok.main(["--encode", "byte", *paths, str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    n = np.fromfile(got, np.int32).size
    assert f"encoded {n} tokens -> {got}" in capsys.readouterr().out
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps({
        "model": "llama.tiny",
        "model_overrides": {"dtype": "float32", "vocab_size": 288},
        "batch": 2, "seq": 32, "steps": 2, "log_every": 1,
        "data": {"kind": "tokens", "path": str(got)}}))
    losses = []
    assert tmain.main(["--config", str(cfg)], device="cpu",
                      on_step=lambda s, v: losses.append(v)) == 0
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_tokenizer_learns_the_jax_vocabulary(tmp_path):
    paths = _corpus(tmp_path)
    want = jtok.train_tokenizer(paths, str(tmp_path / "jax"), vocab_size=300,
                                min_frequency=2)
    assert ttok.main([*paths, str(tmp_path / "port"), "--vocab", "300"]) == 0
    got = ttok.load_tokenizer(str(tmp_path / "port"))
    assert got.vocab_size == want.vocab_size
    for text in ("the quick brown fox", "document 7 lazy dogs"):
        assert got.encode(text) == want.encode(text)
    assert (tmp_path / "port" / "tokenizer.json").read_text() == \
        (tmp_path / "jax" / "tokenizer.json").read_text()
