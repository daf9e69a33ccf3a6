"""Conversation prompt templates, the port's own copy of
``iuvl_tpu/models/llm/conversation.py`` (the reference's vicuna_v1,
llama_2 and plain templates): a template renders (system, [(role,
message), ...]) into the separator format used for generation, with the
same strings.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class Conversation:
    system: str
    roles: tuple[str, str]
    sep: str
    sep2: str | None = None
    style: str = "two"  # 'two' (vicuna), 'llama_2', 'plain'
    messages: list[tuple[str, str | None]] = dataclasses.field(default_factory=list)

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))

    def append_message(self, role: str, message: str | None):
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        if self.style == "plain":
            return self.sep.join(m or "" for _, m in self.messages) + self.sep
        if self.style == "llama_2":
            out = ""
            for i, (role, msg) in enumerate(self.messages):
                if msg is None:
                    continue
                if role == self.roles[0]:
                    sys_txt = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" if i == 0 else ""
                    out += f"[INST] {sys_txt}{msg} [/INST]"
                else:
                    out += f" {msg} </s>"
            return out
        # vicuna v1 style: system + " USER: ...sep ASSISTANT: ...sep2"
        seps = (self.sep, self.sep2 or self.sep)
        out = self.system + seps[0]
        for i, (role, msg) in enumerate(self.messages):
            if msg is None:
                out += f"{role}:"
            else:
                out += f"{role}: {msg}{seps[i % 2]}"
        return out


VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)

conv_templates = {
    "vicuna_v1": Conversation(
        system=VICUNA_SYSTEM, roles=("USER", "ASSISTANT"), sep=" ", sep2="</s>",
        style="two",
    ),
    "llama_2": Conversation(
        system="You are a helpful assistant.", roles=("USER", "ASSISTANT"),
        sep=" ", sep2=" </s><s>", style="llama_2",
    ),
    "plain": Conversation(system="", roles=("", ""), sep="\n", style="plain"),
}


def default_conversation() -> Conversation:
    return conv_templates["vicuna_v1"].copy()
