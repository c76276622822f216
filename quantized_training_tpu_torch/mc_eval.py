"""Offline multiple-choice tasks of the port (counterpart of the JAX
package's ``mc_eval.py``): ``arc``, ``piqa`` and a generic ``mc`` format,
scored the lm-eval harness's way. Each choice is tokenized after its
context, the cross entropy of the continuation's tokens is summed, and the
argmin choice is the prediction. The tasks read local JSONL files, one
object per line:

  arc:  {"question": str, "choices": {"text": [...], "label": [...]},
         "answerKey": "B"}            (ARC-Easy/Challenge HF schema)
  piqa: {"goal": str, "sol1": str, "sol2": str, "label": 0|1}
  mc:   {"ctx": str, "choices": [str, ...], "gold": int}

The token tensor is [N, n_choices, max_len], n_choices the task's largest;
a row with fewer choices carries invalid ones, whose loss is ``+inf``.
Only the continuation counts: the tokens past the longest common prefix of
the context's tokens and the full sequence's. :func:`evaluate_mc` scores
every row: the ragged last batch is padded by repeating its last row, and
the padding's predictions are dropped. The forward runs on the parameters'
device, with no key, under ``torch.no_grad()``; on the card that is the
model's kernels.

:func:`generate_markov_mc` writes an ``mc`` set drawn from the Markov chain
of ``data.MarkovTokenDataset`` (its eval split): the gold choice is a
prompt's sampled continuation, the distractors the continuations of other
rows whose first token no successor of the prompt's last state is. A model
trained on the chain scores far above 1/n_choices; an untrained one sits
near it. The tokens are written as space-joined ids and read back with the
``ints`` tokenizer. The command line generates such a set (pure numpy, no
device):

  python -m quantized_training_tpu_torch.mc_eval runs/mc.jsonl --n_rows 400
  python -m quantized_training_tpu_torch.llm_evaluate --tasks mc --task_data runs/mc.jsonl \\
      --hellaswag_tokenizer ints --ckpt <run>/last.pkl
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _fmt_arc(row):
    texts = row["choices"]["text"]
    labels = [str(l) for l in row["choices"]["label"]]
    gold = labels.index(str(row["answerKey"]))
    ctx = f"Question: {row['question']}\nAnswer:"
    return ctx, [f" {t}" for t in texts], gold


def _fmt_piqa(row):
    ctx = f"Question: {row['goal']}\nAnswer:"
    return ctx, [f" {row['sol1']}", f" {row['sol2']}"], int(row["label"])


def _fmt_mc(row):
    return row["ctx"], list(row["choices"]), int(row["gold"])


FORMATS = {"arc": _fmt_arc, "piqa": _fmt_piqa, "mc": _fmt_mc}


def int_tokenizer(s: str):
    """The tokenizer of token-level tasks: the text is space-joined token
    ids (the Markov task has no surface text)."""
    return [int(t) for t in s.split()]


def generate_markov_mc(
    out_path: str,
    n_rows: int = 400,
    prompt_len: int = 48,
    cont_len: int = 8,
    n_choices: int = 4,
    seed: int = 2024,
    vocab_size: int = 32000,
    n_states: int = 2048,
    branching: int = 8,
) -> str:
    """Write an ``mc`` JSONL set of ``n_rows`` rows from the Markov chain
    of ``MarkovTokenDataset(seed=seed, eval=True)``: prompt ``prompt_len``
    tokens, ``n_choices`` continuations of ``cont_len``; the same bytes as
    the JAX package's generator for the same arguments."""
    from .data.text import MarkovTokenDataset

    ds = MarkovTokenDataset(seq_len=prompt_len + cont_len, vocab_size=vocab_size, n_states=n_states,
                            branching=branching, eval=True, seed=seed, n_samples=n_rows)
    samples = [tok for tok, _ in ds]
    # a distractor must not follow from the prompt's last state: without
    # this filter about n_choices * branching / n_states of the rows get a
    # second continuation that the chain allows
    tok_to_state = {int(t): s for s, t in enumerate(ds._state_to_tok)}
    rng = np.random.Generator(np.random.PCG64([seed, 0x4D43]))  # "MC"
    rows = []
    for i, toks in enumerate(samples):
        prompt = toks[:prompt_len]
        gold_cont = toks[prompt_len:]
        last_state = tok_to_state[int(prompt[-1])]
        valid_next = {int(ds._state_to_tok[s]) for s in ds._succ[last_state]}
        pool = [j for j in range(n_rows) if j != i and int(samples[j][prompt_len]) not in valid_next]
        others = rng.choice(pool, n_choices - 1, replace=False)
        conts = [gold_cont] + [samples[j][prompt_len:] for j in others]
        order = rng.permutation(n_choices)
        rows.append({
            "ctx": " ".join(map(str, prompt)),
            "choices": [" " + " ".join(map(str, conts[k])) for k in order],
            "gold": int(np.argwhere(order == 0)[0, 0]),
        })
    with open(out_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return out_path


def load_rows(data_path: str):
    with open(data_path) as f:
        return [json.loads(line) for line in f if line.strip()]


def tokenize_mc(rows, fmt, tokenizer, max_len: int | None = None):
    """-> tokens [N, C, L] int64 (0 past each sequence), score_mask [N, C,
    L] (True on the continuation's tokens), gold [N], choice_valid [N, C].
    The continuation is the suffix past the longest common prefix of the
    context's tokens and the full sequence's (robust to merges at the
    seam), at least from position 1."""
    parsed = [fmt(r) for r in rows]
    n_choices = max(len(ch) for _, ch, _ in parsed)

    seqs = []
    for ctx, choices, gold in parsed:
        ctx_toks = tokenizer(ctx)
        row_seqs = []
        for ch in choices:
            full = tokenizer(ctx + ch)
            p = 0
            while p < min(len(ctx_toks), len(full)) and ctx_toks[p] == full[p]:
                p += 1
            row_seqs.append((full, max(p, 1)))
        seqs.append((row_seqs, gold))

    L = max_len or max(len(full) for row_seqs, _ in seqs for full, _ in row_seqs)
    N = len(seqs)
    tokens = np.full((N, n_choices, L), 0, dtype=np.int64)
    score_mask = np.zeros((N, n_choices, L), dtype=bool)
    gold_arr = np.zeros(N, dtype=np.int64)
    valid = np.zeros((N, n_choices), dtype=bool)
    for i, (row_seqs, gold) in enumerate(seqs):
        gold_arr[i] = gold
        for j, (full, p) in enumerate(row_seqs):
            full = full[:L]
            tokens[i, j, : len(full)] = full
            score_mask[i, j, min(p, len(full)) : len(full)] = True
            valid[i, j] = True
    return tokens, score_mask, gold_arr, valid


def choice_losses(params, cfg, tokens, score_mask, choice_valid) -> torch.Tensor:
    """The summed continuation losses [N, C] (fp32), ``+inf`` at invalid
    choices: the forward on the N * C sequences of L - 1 tokens, the
    logits cast to fp32, then log_softmax and the gather in plain torch."""
    from .models import llama

    N, C, L = tokens.shape
    with torch.no_grad():
        inputs = tokens[..., :-1].reshape(N * C, L - 1)
        logits = llama.forward(params, inputs, cfg).float()
        targets = tokens[..., 1:].reshape(N * C, L - 1)
        mask = score_mask[..., 1:].reshape(N * C, L - 1)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
        loss = torch.where(mask, nll, 0.0).reshape(N, C, L - 1).sum(-1)
        return torch.where(choice_valid, loss, torch.inf)


def make_predict(cfg):
    """``predict(params, tokens, score_mask, choice_valid) -> [N]``, the
    argmin choice of each row (the first on a tie, as ``jnp.argmin``)."""

    def predict(params, tokens, score_mask, choice_valid):
        return choice_losses(params, cfg, tokens, score_mask, choice_valid).argmin(-1)

    return predict


def evaluate_mc(
    params,
    cfg,
    task: str,
    data_path: str,
    tokenizer: str = "llama3",
    batch_size: int = 8,
    max_rows: int | None = None,
) -> float:
    """The accuracy over every row of ``data_path`` (the first ``max_rows``)
    in ``task``'s format; ``tokenizer`` a name of ``get_tokenizer``,
    ``'ints'``, or a callable."""
    from .data import get_tokenizer

    rows = load_rows(data_path)
    if max_rows is not None:
        rows = rows[:max_rows]
    if tokenizer == "ints":
        tok = int_tokenizer
    else:
        tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
    tokens, score_mask, gold, valid = tokenize_mc(rows, FORMATS[task], tok)

    predict = make_predict(cfg)
    device = params["embed"]["embedding"].device
    n_correct = 0
    n = len(tokens)
    for i in range(0, n, batch_size):
        sl = slice(i, min(i + batch_size, n))
        t, m, v = tokens[sl], score_mask[sl], valid[sl]
        pad = batch_size - len(t)
        if pad:  # the ragged tail: repeat its last row, drop its predictions
            t = np.concatenate([t, np.repeat(t[-1:], pad, 0)])
            m = np.concatenate([m, np.repeat(m[-1:], pad, 0)])
            v = np.concatenate([v, np.repeat(v[-1:], pad, 0)])
        preds = predict(params, *(torch.from_numpy(a).to(device) for a in (t, m, v)))
        preds = preds.cpu().numpy()[: sl.stop - sl.start]
        n_correct += int((preds == gold[sl]).sum())
    return n_correct / max(n, 1)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate the Markov-chain MC task (writes 'mc' jsonl; evaluate with "
        "python -m quantized_training_tpu_torch.llm_evaluate --tasks mc --task_data <path> "
        "--hellaswag_tokenizer ints)")
    p.add_argument("out_path")
    p.add_argument("--n_rows", type=int, default=400)
    p.add_argument("--prompt_len", type=int, default=48)
    p.add_argument("--cont_len", type=int, default=8)
    p.add_argument("--n_choices", type=int, default=4)
    p.add_argument("--seed", type=int, default=2024)
    p.add_argument("--vocab_size", type=int, default=32000)
    p.add_argument("--n_states", type=int, default=2048)
    p.add_argument("--branching", type=int, default=8)
    return p


def main(argv: list[str] | None = None) -> str:
    """Writes the set; returns its path."""
    a = _parser().parse_args(argv)
    path = generate_markov_mc(**vars(a))
    print(f"wrote {a.n_rows} rows to {path}")
    return path


if __name__ == "__main__":
    main()
