"""ESPnet-style hypothesis utilities (a copy of the JAX package's
``utils/hypotheses.py``): the recognition helpers of the reference's
``transformer/utils.py:11-92``, used with beam search's n-best outputs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def process_dict(dict_path: str) -> Tuple[List[str], int, int]:
    """Read a token dictionary file ('<token> <id>' per line); returns
    (char_list, sos_id, eos_id)."""
    with open(dict_path, "rb") as f:
        lines = f.readlines()
    char_list = [entry.decode("utf-8").split(" ")[0] for entry in lines]
    return char_list, char_list.index("<sos>"), char_list.index("<eos>")


def parse_hypothesis(hyp: Dict, char_list: Sequence[str]
                     ) -> Tuple[str, str, str, float]:
    """Hypothesis dict {'yseq', 'score'} -> (text, token, tokenid, score);
    yseq[0] is sos and is dropped."""
    tokenid_as_list = [int(i) for i in hyp["yseq"][1:]]
    token_as_list = [char_list[i] for i in tokenid_as_list]
    score = float(hyp["score"])
    tokenid = " ".join(str(i) for i in tokenid_as_list)
    token = " ".join(token_as_list)
    text = "".join(token_as_list).replace("<space>", " ")
    return text, token, tokenid, score


def add_results_to_json(js: Dict, nbest_hyps: List[Dict],
                        char_list: Sequence[str]) -> Dict:
    """Attach n-best recognition results to a groundtruth utterance dict."""
    new_js: Dict = {"utt2spk": js["utt2spk"], "output": []}
    for n, hyp in enumerate(nbest_hyps, 1):
        text, token, tokenid, score = parse_hypothesis(hyp, char_list)
        out = dict(js["output"][0].items())
        out["name"] = out.get("name", "") + f"[{n}]"
        out["rec_text"] = text
        out["rec_token"] = token
        out["rec_tokenid"] = tokenid
        out["score"] = score
        new_js["output"].append(out)
    return new_js


def beam_outputs_to_hyps(tokens, scores) -> List[List[Dict]]:
    """``decode/beam.py`` outputs ((B, K, L) tokens, (B, K) scores; tensors
    or arrays) as the hypothesis dicts the helpers above consume."""
    out = []
    for b in range(tokens.shape[0]):
        out.append([{"yseq": [int(t) for t in tokens[b, k]],
                     "score": float(scores[b, k])}
                    for k in range(tokens.shape[1])])
    return out
