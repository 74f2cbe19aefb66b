"""Conversation templates and the preprocessing masks
(visper_lm_tpu_torch/conversation.py, data/preprocess.py) vs the JAX
package's: every template's prompt string, and `preprocess`'s input ids and
labels for each template, with and without an image, one to three rounds:
exactly equal.
"""

import copy

import pytest

from visper_lm_tpu import conversation as jconv
from visper_lm_tpu.data import preprocess as jpre

from visper_lm_tpu_torch import conversation as tconv
from visper_lm_tpu_torch.data import preprocess as tpre

from test_data_pipeline import FakeTokenizer

TEMPLATES = sorted(jconv.conv_templates)

DIALOGUES = [
    [("human", "<image>\ndescribe the image"), ("gpt", "a cat on a mat")],
    [("human", "what is <image> this thing?"), ("gpt", "a red ball"),
     ("human", "what color?"), ("gpt", "red, mostly")],
    [("gpt", "hello"), ("human", "<image>\nhi there"), ("gpt", "one two three"),
     ("human", "more"), ("gpt", "four"), ("human", "and?"), ("gpt", "five six")],
]


def _render(module, name, turns):
    conv = module.conv_templates[name].copy()
    for i, msg in enumerate(turns):
        conv.append_message(conv.roles[i % 2], msg)
    return conv.get_prompt()


def test_the_same_templates():
    assert sorted(tconv.conv_templates) == TEMPLATES
    for name, t in jconv.conv_templates.items():
        p = tconv.conv_templates[name]
        assert (p.system, p.roles, p.sep, p.sep2, p.version, p.sep_style.name) == \
            (t.system, t.roles, t.sep, t.sep2, t.version, t.sep_style.name)


@pytest.mark.parametrize("name", TEMPLATES)
@pytest.mark.parametrize("turns", [
    ["<image>\nwhat is this?", None],
    ["<image>\nwhat is this?", "a dog", "and its color?", None],
    ["hi", "hello", "how are you?", "fine", "bye", None],
    [("<image> look at it", "image", "pad"), None],
])
def test_get_prompt_equals_jax(name, turns):
    def outcome(module):
        # "plain" has no sep2: a second turn fails in both packages alike
        try:
            return _render(module, name, turns)
        except TypeError as e:
            return type(e)

    assert outcome(tconv) == outcome(jconv)


def test_single_style_and_copy_equal_jax():
    kw = dict(system="sys", roles=("A", "B"), offset=0, sep="###")
    j = jconv.Conversation(**kw, messages=[], sep_style=jconv.SeparatorStyle.SINGLE)
    t = tconv.Conversation(**kw, messages=[], sep_style=tconv.SeparatorStyle.SINGLE)
    for c in (j, t):
        c.append_message("A", "x")
        c.append_message("B", None)
    assert t.get_prompt() == j.get_prompt()
    c = t.copy()
    c.append_message("A", "more")
    assert len(t.messages) == 2 and len(c.messages) == 3


def _sources(dialogue):
    return [[{"from": who, "value": text} for who, text in dialogue]]


@pytest.mark.parametrize("name", ["llava_phi_3", "llava_llama_3", "vicuna_v1", "v1"])
@pytest.mark.parametrize("dialogue", range(len(DIALOGUES)))
@pytest.mark.parametrize("has_image", [True, False])
def test_preprocess_ids_and_labels_equal_jax(name, dialogue, has_image):
    tok = FakeTokenizer()
    src = _sources(DIALOGUES[dialogue])
    if has_image:
        jsrc = jpre.preprocess_multimodal(copy.deepcopy(src))
        tsrc = tpre.preprocess_multimodal(copy.deepcopy(src))
        assert tsrc == jsrc
    else:
        jsrc = tsrc = [[{"from": s["from"], "value": s["value"].replace("<image>", "img")}
                        for s in src[0]]]
    ref = jpre.preprocess(copy.deepcopy(jsrc), tok, name, has_image=has_image)
    got = tpre.preprocess(copy.deepcopy(tsrc), tok, name, has_image=has_image)
    assert [(e.input_ids, e.labels) for e in got] == [(e.input_ids, e.labels) for e in ref]
    if dialogue == 0:
        # one round: the answer is supervised (later rounds' length arithmetic
        # assumes a real tokenizer's merges and masks this one out, in both)
        assert any(label != -100 for label in got[0].labels)


@pytest.mark.parametrize("max_len", [8, 4096])
def test_preprocess_truncation_equals_jax(max_len):
    tok = FakeTokenizer()
    src = _sources(DIALOGUES[1])
    ref = jpre.preprocess(copy.deepcopy(src), tok, "llava_llama_3", model_max_length=max_len)
    got = tpre.preprocess(copy.deepcopy(src), tok, "llava_llama_3", model_max_length=max_len)
    assert [(e.input_ids, e.labels) for e in got] == [(e.input_ids, e.labels) for e in ref]


def test_preprocess_plain_and_start_end_tokens_equal_jax():
    tok = FakeTokenizer()
    src = _sources([("human", "<image>\nignored"), ("gpt", "a caption here")])
    ref = jpre.preprocess(copy.deepcopy(src), tok, "plain", has_image=True)
    got = tpre.preprocess(copy.deepcopy(src), tok, "plain", has_image=True)
    assert [(e.input_ids, e.labels) for e in got] == [(e.input_ids, e.labels) for e in ref]
    src = _sources(DIALOGUES[1])
    assert (tpre.preprocess_multimodal(copy.deepcopy(src), mm_use_im_start_end=True)
            == jpre.preprocess_multimodal(copy.deepcopy(src), mm_use_im_start_end=True))
