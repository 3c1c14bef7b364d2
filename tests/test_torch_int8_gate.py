"""The int8-FFN gate's cached verdict (``int8_ffn_check.cuda.json``).

A marker that cannot be read (truncated, not JSON, not an object) is
treated as absent: the gate measures again and rewrites it, as the JAX
package's gate does.  A valid marker at the same threshold is reused
without a forward.  An exception of the gate's own forward propagates.
"""

import json
import logging

import pytest
import torch

from tpu_search_torch.models.encoder import (
    INT8_GATE_FILE,
    INT8_GATE_THRESHOLD,
    EmbeddingGenerator,
)
from tpu_search_torch.models.mpnet import MPNetConfig


class _Model:
    """Stands in for MPNetModel: embeddings of the bf16 and int8 FFN that
    agree to ``cosine``; counts its forwards."""

    def __init__(self, cosine=1.0, fail=False):
        self.cosine, self.fail, self.calls = cosine, fail, 0

    def quantize_ffn(self):
        pass

    def __call__(self, ids, mask, int8_ffn=False):
        self.calls += 1
        if self.fail:
            raise RuntimeError("forward failed")
        n = ids.shape[0]
        base = torch.zeros((n, 2))
        base[:, 0] = 1.0
        if not int8_ffn:
            return base
        c = self.cosine
        return torch.stack([torch.full((n,), c),
                            torch.full((n,), (1 - c * c) ** 0.5)], dim=1)


def _generator(model):
    gen = EmbeddingGenerator.__new__(EmbeddingGenerator)
    gen._model = model
    gen._model_config = MPNetConfig(vocab_size=64)
    gen._device = torch.device("cpu")
    gen.logger = logging.getLogger("test_int8_gate")
    return gen


@pytest.mark.parametrize("text", ['{"ok": tr', "", "not json", "[1, 2]",
                                  '"a string"'])
def test_unreadable_marker_is_measured_again_and_rewritten(tmp_path, text):
    marker = tmp_path / INT8_GATE_FILE
    marker.write_text(text)
    model = _Model(cosine=1.0)
    assert _generator(model)._int8_ffn_gate(tmp_path) is True
    assert model.calls == 2  # the bf16 and the int8 forward
    cached = json.loads(marker.read_text())
    assert cached["ok"] is True
    assert cached["threshold"] == INT8_GATE_THRESHOLD


def test_valid_marker_is_reused(tmp_path):
    marker = tmp_path / INT8_GATE_FILE
    marker.write_text(json.dumps({"ok": False,
                                  "threshold": INT8_GATE_THRESHOLD,
                                  "min_cosine": 0.5}))
    model = _Model(cosine=1.0)
    gen = _generator(model)
    assert gen._int8_ffn_gate(tmp_path) is False
    assert model.calls == 0
    assert gen.int8_gate["min_cosine"] == 0.5


def test_marker_of_another_threshold_is_measured_again(tmp_path):
    marker = tmp_path / INT8_GATE_FILE
    marker.write_text(json.dumps({"ok": True, "threshold": 0.5}))
    model = _Model(cosine=0.9)
    assert _generator(model)._int8_ffn_gate(tmp_path) is False
    assert model.calls == 2
    assert json.loads(marker.read_text())["ok"] is False


def test_forward_error_propagates(tmp_path):
    (tmp_path / INT8_GATE_FILE).write_text('{"ok": tr')
    with pytest.raises(RuntimeError, match="forward failed"):
        _generator(_Model(fail=True))._int8_ffn_gate(tmp_path)
