"""Conversation -> (input_ids, labels) per prompt template (a copy of
visper_lm_tpu/data/preprocess.py).

The masking decides which tokens carry the NTP loss, so its arithmetic is
the JAX package's exactly, per template:

  * llama3 (MPT-style, sep "<|eot_id|>"): rounds regrouped as [sys+user+gpt],
    then [user+gpt] pairs; instruction_len = len(tok(parts[0])) - 2;
  * phi3 (MPT-style, sep "<|end|>"): the same, with round_len and
    instruction_len each 2 shorter when i > 0;
  * v1 / vicuna (TWO-style): rounds split on sep2 "</s>"; 1 shorter when
    i != 0 (non-legacy tokenizers);
  * plain: the '<image>\\n' turn masked, the caption supervised.

`preprocess_multimodal` moves '<image>' to the front of its turn, followed by
a newline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from visper_lm_tpu_torch import conversation as conversation_lib
from visper_lm_tpu_torch.constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
)
from visper_lm_tpu_torch.data.mm_utils import tokenizer_image_token


@dataclasses.dataclass
class PreprocessedExample:
    input_ids: List[int]
    labels: List[int]


def preprocess_multimodal(
    sources: List[List[Dict[str, str]]],
    *,
    mm_use_im_start_end: bool = False,
) -> List[List[Dict[str, str]]]:
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = DEFAULT_IMAGE_TOKEN + "\n" + sentence["value"]
                sentence["value"] = sentence["value"].strip()
            if mm_use_im_start_end:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN,
                )
    return sources


def _render_conversations(
    sources: List[List[Dict[str, str]]], conv: conversation_lib.Conversation
) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    out = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        c = conv.copy()
        c.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            if role != c.roles[j % 2]:
                raise ValueError("conversation roles must alternate")
            c.append_message(role, sentence["value"])
        out.append(c.get_prompt())
    return out


def _tokenize(text: str, tokenizer, has_image: bool) -> List[int]:
    if has_image:
        return tokenizer_image_token(text, tokenizer)
    return list(tokenizer(text).input_ids)


def _mask_mpt_style(
    conversation: str,
    input_ids: List[int],
    tokenizer,
    conv: conversation_lib.Conversation,
    has_image: bool,
    model_max_length: int,
    per_round_adjust: int,
) -> List[int]:
    """Masking shared by the MPT-style templates (llama3 / phi3)."""
    labels = list(input_ids)
    sep = conv.sep + conv.roles[1]

    rounds = conversation.split(conv.sep)
    re_rounds = [conv.sep.join(rounds[:3])]
    for idx in range(3, len(rounds), 2):
        re_rounds.append(conv.sep.join(rounds[idx : idx + 2]))

    cur_len = 1
    labels[:cur_len] = [IGNORE_INDEX] * cur_len
    for i, rou in enumerate(re_rounds):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep

        round_len = len(_tokenize(rou, tokenizer, has_image))
        instruction_len = len(_tokenize(parts[0], tokenizer, has_image)) - 2
        if i > 0:
            round_len += per_round_adjust
            instruction_len += per_round_adjust

        end = min(cur_len + instruction_len, len(labels))
        labels[cur_len:end] = [IGNORE_INDEX] * (end - cur_len)
        cur_len += round_len

    labels[cur_len:] = [IGNORE_INDEX] * (len(labels) - cur_len)

    if cur_len < model_max_length and cur_len != len(input_ids):
        # a tokenization mismatch drops the example's supervision entirely
        labels = [IGNORE_INDEX] * len(labels)
    return labels


def _mask_two_style(
    conversation: str,
    input_ids: List[int],
    tokenizer,
    conv: conversation_lib.Conversation,
    has_image: bool,
    model_max_length: int,
    legacy_tokenizer: bool = False,
) -> List[int]:
    """Masking for the TWO-style vicuna_v1 template."""
    labels = list(input_ids)
    sep = conv.sep + conv.roles[1] + ": "

    rounds = conversation.split(conv.sep2)
    cur_len = 1
    labels[:cur_len] = [IGNORE_INDEX] * cur_len
    for i, rou in enumerate(rounds):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep

        round_len = len(_tokenize(rou, tokenizer, has_image))
        instruction_len = len(_tokenize(parts[0], tokenizer, has_image)) - 2
        if i != 0 and not legacy_tokenizer:
            round_len -= 1
            instruction_len -= 1

        end = min(cur_len + instruction_len, len(labels))
        labels[cur_len:end] = [IGNORE_INDEX] * (end - cur_len)
        cur_len += round_len

    labels[cur_len:] = [IGNORE_INDEX] * (len(labels) - cur_len)

    if cur_len < model_max_length and cur_len != len(input_ids):
        labels = [IGNORE_INDEX] * len(labels)
    return labels


def preprocess_plain(
    sources: List[List[Dict[str, str]]],
    tokenizer,
) -> List[PreprocessedExample]:
    """LLaVA pretraining pairs: the '<image>' prompt masked, the caption supervised."""
    out = []
    conv = conversation_lib.conv_llava_plain
    for source in sources:
        if len(source) != 2 or DEFAULT_IMAGE_TOKEN not in source[0]["value"]:
            raise ValueError("a plain example is one '<image>' turn and one caption")
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversation = source[0]["value"] + source[1]["value"] + conv.sep
        input_ids = tokenizer_image_token(conversation, tokenizer)
        labels = list(input_ids)
        prompt_len = len(tokenizer_image_token(source[0]["value"], tokenizer))
        labels[:prompt_len] = [IGNORE_INDEX] * prompt_len
        out.append(PreprocessedExample(input_ids=input_ids, labels=labels))
    return out


def preprocess(
    sources: List[List[Dict[str, str]]],
    tokenizer,
    template_name: str,
    *,
    has_image: bool = False,
    model_max_length: int = 4096,
) -> List[PreprocessedExample]:
    """Dispatch on the template."""
    if template_name == "plain":
        return preprocess_plain(sources, tokenizer)

    conv = conversation_lib.conv_templates[template_name]
    out = []
    for conversation in _render_conversations(sources, conv):
        input_ids = _tokenize(conversation, tokenizer, has_image)[:model_max_length]
        if conv.version == "llama3":
            labels = _mask_mpt_style(
                conversation, input_ids, tokenizer, conv, has_image,
                model_max_length, per_round_adjust=0,
            )
        elif conv.version == "phi3":
            labels = _mask_mpt_style(
                conversation, input_ids, tokenizer, conv, has_image,
                model_max_length, per_round_adjust=-2,
            )
        elif conv.version.startswith("v1"):
            labels = _mask_two_style(
                conversation, input_ids, tokenizer, conv, has_image, model_max_length
            )
        else:
            raise ValueError(f"unknown template: {template_name}")
        out.append(PreprocessedExample(input_ids=input_ids, labels=labels))
    return out
