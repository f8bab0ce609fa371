"""Build the multimodal action embedding table (mirror of HRI
scripts/collect_act_emb.py:42-54): catalog tsv → concat(one-hot act,
one-hot exp, text-encoder(utterance)) rows → raw_wae.npy.

    python -m paddlerobotics_torch.cli.collect_act_emb --catalog acts.tsv \\
        --encoder ernie [--device cpu]

``--encoder random`` draws the utterance rows from numpy's ``RandomState``
(the same table as the JAX CLI's); ``bow`` and ``ernie`` run the encoder on
seeded weights on the card unless ``--device cpu``. With the default
3-token vocab (``UtteranceEncoder``) every word of an utterance is
``[UNK]``, so under ``ernie`` utterances with the same word count share an
embedding, as in the JAX CLI."""

from __future__ import annotations

import argparse

import numpy as np
import torch


def read_catalog(path: str) -> list:
    """tsv rows act \\t exp \\t utterance \\t movement → MultimodalActions
    (missing trailing fields are "null")."""
    from paddlerobotics_torch.hri import actions as am

    catalog = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            catalog.append(am.MultimodalAction(*(parts + ["null"] * 4)[:4]))
    return catalog


def encode_utterances(texts: list, encoder: str, seed: int,
                      device=None) -> np.ndarray:
    """(len(texts), 768) utterance embeddings: ``bow`` over a character
    vocab of the texts (32 tokens), ``ernie`` through ``UtteranceEncoder``
    (64 tokens), each on seeded weights on ``resolve_device(device)``."""
    from paddlerobotics_torch.core.device import resolve_device
    from paddlerobotics_torch.hri.perception.utterance import (
        BoWEncoder, UtteranceEncoder, WordPieceTokenizer)

    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        if encoder == "bow":
            vocab = {"[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
            for t in texts:
                for ch in t:
                    vocab.setdefault(ch, len(vocab) + 1)
            tok = WordPieceTokenizer(vocab)
            ids = torch.as_tensor(np.stack([tok.encode(t, 32) for t in texts]),
                                  dtype=torch.int64, device=dev)
            enc = BoWEncoder(vocab_size=len(vocab) + 2, device=dev,
                             generator=gen)
            return enc(ids).cpu().numpy()
        ue = UtteranceEncoder(device=dev)
        ue.init(gen)
        return ue.encode(texts).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--catalog", type=str, required=True,
                   help="tsv: act \\t exp \\t utterance \\t movement")
    p.add_argument("--out", type=str, default="raw_wae.npy")
    p.add_argument("--version", type=str, default="v1")
    p.add_argument("--encoder", type=str, default="random",
                   choices=["random", "bow", "ernie"],
                   help="utterance encoder (pretrained weights are not "
                        "bundled; random/bow for bootstrap)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="bow/ernie: cuda (default) or cpu")
    args = p.parse_args(argv)

    from paddlerobotics_torch.hri import actions as am

    catalog = read_catalog(args.catalog)
    if args.encoder == "random":
        rng = np.random.RandomState(args.seed)
        utt = rng.randn(len(catalog), 768).astype(np.float32) * 0.02
    else:
        utt = encode_utterances([a.utterance for a in catalog], args.encoder,
                                args.seed, args.device)

    table = am.build_action_embeddings(catalog, utt, version=args.version)
    np.save(args.out, table)
    print(f"{table.shape} → {args.out}")
    return table


if __name__ == "__main__":
    main()
