"""Conversation prompt templates (a copy of visper_lm_tpu/conversation.py).

The shipped templates: vicuna_v1 (TWO-style), llava_llama_3 and llava_phi_3
(MPT-style) and plain. Rendered strings must equal the JAX package's byte for
byte: they decide tokenization, label masks and eval prompts.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        if messages and isinstance(messages[0][1], tuple):
            # (message, image, preprocess-mode) tuples from a chat UI: the
            # image tag goes to the front of the first user turn
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace("<image>", "").strip()
            messages[0] = [init_role, "<image>\n" + init_msg]

        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret

        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret

        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += message + seps[i % 2]
            return ret

        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=[[r, m] for r, m in self.messages])


conv_vicuna_v1 = Conversation(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_llama_3 = Conversation(
    system=(
        "<|start_header_id|>system<|end_header_id|>\n\nA chat between a curious user and "
        "an artificial intelligence assistant. The assistant gives helpful, detailed, and "
        "polite answers to the user's questions."
    ),
    roles=(
        "<|start_header_id|>user<|end_header_id|>\n\n",
        "<|start_header_id|>assistant<|end_header_id|>\n\n",
    ),
    version="llama3",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|eot_id|>",
)

conv_llava_phi_3 = Conversation(
    system="<|system|>\nYou are a helpful AI assistant.",
    roles=("\n<|user|>\n", "\n<|assistant|>\n"),
    version="phi3",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|end|>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    version="plain",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

default_conversation = conv_llava_phi_3

conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_phi_3": conv_llava_phi_3,
    "llava_llama_3": conv_llava_llama_3,
    "plain": conv_llava_plain,
}
