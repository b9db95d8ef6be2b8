"""Chat request message model (DIAL-extended OpenAI messages)."""

from enum import Enum
from typing import Any

from dial_rag_tpu_torch.service._model import BaseModel, ConfigDict, Field


class Role(str, Enum):
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"
    FUNCTION = "function"
    TOOL = "tool"


class RequestAttachment(BaseModel):
    model_config = ConfigDict(extra="allow")

    type: str | None = None
    title: str | None = None
    data: str | None = None
    url: str | None = None
    reference_url: str | None = None


class CustomContent(BaseModel):
    model_config = ConfigDict(extra="allow")

    attachments: list[RequestAttachment] | None = None
    state: Any | None = None


class Message(BaseModel):
    model_config = ConfigDict(extra="allow")

    role: Role
    # str for normal messages; OpenAI list-of-parts content is accepted
    # at the schema level and rejected later with the curated
    # "Message content is not a string" 400 (reference behavior)
    content: str | list | None = None
    custom_content: CustomContent | None = None


class CustomFields(BaseModel):
    model_config = ConfigDict(extra="allow")

    configuration: dict | None = None


class ChatRequest(BaseModel):
    model_config = ConfigDict(extra="allow")

    messages: list[Message]
    stream: bool = False
    custom_fields: CustomFields | None = None
    api_key: str = Field(default="", exclude=True)  # from the api-key header
