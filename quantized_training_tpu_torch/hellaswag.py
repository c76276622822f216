"""HellaSwag accuracy of the port (counterpart of the JAX package's
``hellaswag.py``): 4-choice classification by the least summed cross
entropy over a fixed-shape [N, 4, 193] token tensor, with the
lm-evaluation-harness preprocessing.

The rows come from a local JSON or JSONL file (``data_path``; each row
``ctx_a``, ``ctx_b``, ``activity_label``, ``endings``, ``label``) or from the
hub's ``Rowan/hellaswag`` split through ``datasets``, imported only then.
As in the JAX package, the whole sequence is scored (context and ending;
padding, -100, is fed as token 0 and not scored), and
:func:`evaluate_hellaswag` runs fixed batches and drops the ragged tail.
The forward runs on the parameters' device, with no key, under
``torch.no_grad()``.

There is no command line, as the JAX module has none:
``python -m quantized_training_tpu_torch.llm_evaluate --tasks hellaswag
--hellaswag_data <file>`` and ``llm_pretrain --hellaswag`` run it.
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch


def preprocess(text: str) -> str:
    text = text.strip()
    text = text.replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    text = text.replace("  ", " ")
    return text


def _load_rows(split: str, data_path: str | None):
    if data_path is not None:
        with open(data_path) as f:
            if str(data_path).endswith(".jsonl"):
                return [json.loads(line) for line in f]
            return json.load(f)
    from datasets import load_dataset

    return load_dataset("Rowan/hellaswag", split=split)


def tokenize_rows(rows, tokenizer, max_len: int = 193) -> tuple[np.ndarray, np.ndarray]:
    """-> tokens [N, 4, max_len] int64 (pad = -100), labels [N]."""
    tokens = np.full((len(rows), 4, max_len), -100, dtype=np.int64)
    labels = np.zeros(len(rows), dtype=np.int64)
    for i, row in enumerate(rows):
        ctx = f"{row['activity_label']}: {row['ctx_a']} {row['ctx_b'].capitalize()}"
        for j, ending in enumerate(row["endings"]):
            toks = tokenizer(preprocess(f"{ctx} {ending}"))
            assert len(toks) <= max_len, len(toks)
            tokens[i, j, : len(toks)] = toks
        labels[i] = int(row["label"])
    return tokens, labels


def choice_losses(params, cfg, data: torch.Tensor) -> torch.Tensor:
    """The summed losses [N, 4] (fp32) of ``data`` [N, 4, L]: the forward
    on the N * 4 sequences of L - 1 tokens (-100 fed as token 0), every
    position whose next token is not -100 scored."""
    from .models import llama

    N, n_choices, seq_len = data.shape
    with torch.no_grad():
        inputs = data[..., :-1].reshape(N * n_choices, seq_len - 1)
        logits = llama.forward(params, inputs.clamp(min=0), cfg).float()
        labels = data[..., 1:].reshape(N * n_choices, seq_len - 1)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels.clamp(min=0)[..., None])[..., 0]
        nll = torch.where(labels != -100, nll, 0.0)
        return nll.reshape(N, n_choices, seq_len - 1).sum(-1)


def make_predict(cfg):
    """``predict(params, data) -> [N]``, the argmin ending of each row."""

    def predict(params, data):
        return choice_losses(params, cfg, data).argmin(-1)

    return predict


def evaluate_hellaswag(
    params,
    cfg,
    tokenizer: str = "llama3",
    split: str = "validation",
    data_path: str | None = None,
    batch_size: int = 8,
    max_rows: int | None = None,
) -> float:
    """The accuracy over the first ``len // batch_size`` batches of the
    rows (the ragged tail is dropped, as in the JAX package)."""
    from .data import get_tokenizer

    rows = _load_rows(split, data_path)
    if max_rows is not None:
        rows = rows[:max_rows] if isinstance(rows, list) else rows.select(range(max_rows))
    tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
    tokens, labels = tokenize_rows(rows, tok)

    predict = make_predict(cfg)
    device = params["embed"]["embedding"].device
    n_correct = 0
    n = len(tokens) - len(tokens) % batch_size  # fixed shape, no ragged tail
    for i in range(0, n, batch_size):
        preds = predict(params, torch.from_numpy(tokens[i : i + batch_size]).to(device))
        n_correct += int((preds.cpu().numpy() == labels[i : i + batch_size]).sum())
    return n_correct / max(n, 1)
