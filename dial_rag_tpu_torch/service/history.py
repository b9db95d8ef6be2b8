"""Chat history transformation (mirror of reference transform_history.py):
drop empty messages (some models reject them) and restore assistant
citations [n] back to the <[n]> form the prompt teaches, so history stays
consistent with the citation format."""

import re

from dial_rag_tpu_torch.service.messages import Message, Role

REF_HISTORY_PATTERN = re.compile(r"\[(\d+)\]")


def transform_history(messages: list[Message]) -> list[dict]:
    """DIAL messages -> plain chat messages for the LLM."""
    out: list[dict] = []
    for message in messages:
        content = message.content
        if not content:
            continue
        if message.role == Role.ASSISTANT:
            content = REF_HISTORY_PATTERN.sub(r"<[\1]>", content)
        out.append({"role": message.role.value, "content": content})
    return out


def get_number_of_user_messages(history: list[dict]) -> int:
    return sum(m["role"] == "user" for m in history)
