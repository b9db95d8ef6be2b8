"""In-message slash commands.

Covers the reference's command set (reference commands.py): /attach,
/model, /query_model, /profile, /ignore_document_loading_errors.
Unlike the reference — which discovers commands by reflecting over
pydantic model fields — this module is a flat registry: each command
is one entry naming its group, its argument parser, and where the
value lands. Adding a command is adding a row.

Divergence (documented): a command line must be ``/name`` or
``/name arg`` with a whitespace boundary after the name. The
reference's prefix match treats ``/modelxyz`` as ``/model xyz``;
here it stays message text.
"""

import re
from copy import deepcopy
from dataclasses import dataclass, field
from typing import Any, Callable

from dial_rag_tpu_torch.service.config import create_update_dict, deep_merge
from dial_rag_tpu_torch.service.messages import (
    CustomContent,
    Message,
    RequestAttachment,
    Role,
)


@dataclass
class DebugCommands:
    profile: bool = False
    model: str | None = None
    query_model: str | None = None


@dataclass
class ConfCommands:
    ignore_document_loading_errors: bool = False


@dataclass
class Commands:
    debug: DebugCommands = field(default_factory=DebugCommands)
    conf: ConfCommands = field(default_factory=ConfCommands)


def _as_flag(arg: str) -> bool:
    # a bare flag command means "on"; an explicit argument must say true
    return arg.lower() in ("", "true")


@dataclass(frozen=True)
class _Command:
    # sink(commands, attach_urls, parsed_argument)
    sink: Callable[[Commands, list[str], Any], None]
    parse: Callable[[str], Any] = lambda arg: arg


_REGISTRY: dict[str, _Command] = {
    "attach": _Command(sink=lambda c, urls, v: urls.append(v)),
    "profile": _Command(
        sink=lambda c, urls, v: setattr(c.debug, "profile", v),
        parse=_as_flag,
    ),
    "model": _Command(
        sink=lambda c, urls, v: setattr(c.debug, "model", v),
    ),
    "query_model": _Command(
        sink=lambda c, urls, v: setattr(c.debug, "query_model", v),
    ),
    "ignore_document_loading_errors": _Command(
        sink=lambda c, urls, v: setattr(
            c.conf, "ignore_document_loading_errors", v
        ),
        parse=_as_flag,
    ),
}


_COMMAND_LINE = re.compile(r"/(\w+)(?:\s(.*))?$", re.DOTALL)


def _match_command(line: str) -> tuple[str, str] | None:
    """``/name`` or ``/name <ws> arg...`` -> (name, arg) when name is
    registered. Any whitespace terminates the name (clients send tabs
    and CRLF line endings; a trailing \\r must not turn /profile into
    message text)."""
    m = _COMMAND_LINE.match(line)
    if m is None or m.group(1) not in _REGISTRY:
        return None
    return m.group(1), (m.group(2) or "").strip()


def process_message_commands(message: Message, commands: Commands) -> Message:
    if message.role != Role.USER or not isinstance(message.content, str):
        # no content / assistant text / list-of-parts content (the
        # request handler rejects the latter with the curated 400)
        return message

    kept_lines: list[str] = []
    attach_urls: list[str] = []
    consumed = 0
    for line in message.content.split("\n"):
        matched = _match_command(line)
        if matched is None:
            kept_lines.append(line)
            continue
        name, arg = matched
        command = _REGISTRY[name]
        command.sink(commands, attach_urls, command.parse(arg))
        consumed += 1

    if not consumed:
        return message  # identity-preserved: callers rely on `is`

    stripped = deepcopy(message)
    stripped.content = "\n".join(kept_lines)
    if attach_urls:
        if not stripped.custom_content:
            stripped.custom_content = CustomContent()
        if not stripped.custom_content.attachments:
            stripped.custom_content.attachments = []
        stripped.custom_content.attachments.extend(
            RequestAttachment(type=None, url=url) for url in attach_urls
        )
    return stripped


def process_commands(
    messages: list[Message], enable_debug_commands: bool
) -> tuple[list[Message], Commands]:
    """Strip command lines from all user messages and collect their
    values. Debug commands are always stripped from the text but their
    values are dropped unless enabled (reference commands.py:138-149)."""
    commands = Commands()
    result = [process_message_commands(m, commands) for m in messages]
    if not enable_debug_commands:
        commands.debug = DebugCommands()
    return result, commands


# where each command value lands in the request-config overlay;
# deep-merged because /model and /query_model share the qa_chain subtree
_CONFIG_TARGETS: tuple[tuple[Callable[[Commands], Any], str], ...] = (
    (lambda c: c.debug.model, "qa_chain.chat_chain.llm.deployment_name"),
    (
        lambda c: c.debug.query_model,
        "qa_chain.query_chain.llm.deployment_name",
    ),
    (lambda c: c.debug.profile, "use_profiler"),
    (
        lambda c: c.conf.ignore_document_loading_errors,
        "ignore_document_loading_errors",
    ),
)


def commands_to_config_dict(commands: Commands) -> dict[str, Any]:
    config_dict: dict[str, Any] = {}
    for read, dotted_path in _CONFIG_TARGETS:
        value = read(commands)
        if value:  # unset strings are None, unset flags are False
            config_dict = deep_merge(
                config_dict, create_update_dict(dotted_path, value)
            )
    return config_dict
