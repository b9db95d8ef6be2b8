"""The part of pydantic's ``BaseModel`` that the service's models use, on
the standard library (the card's machine has no pydantic).

Declared fields with defaults, ``default_factory`` and ``Field(...)``
(description, ge, le, exclude, validation_alias); nested
models, ``X | None``, ``list[...]``, ``dict[str, ...]``, ``Literal``,
``str`` enums, ``Any``, ``Annotated`` and ``ClassVar``; ``model_config``
with ``extra`` ("forbid", "allow", "ignore") and ``frozen``;
``field_validator`` (after-validators); ``model_fields``;
``model_validate`` with pydantic's lax coercions for those types;
``model_dump`` (``mode``, ``exclude_unset``, ``exclude_none``);
``model_dump_json`` with pydantic's bytes (UTF-8 kept, floats written as
serde_json writes them, non-finite floats as null); and
``model_json_schema`` in pydantic's layout (auto-titles, ``anyOf`` with
``{"type": "null"}``, ``$defs`` / ``$ref``, dumped defaults, enum
definitions, keys sorted as pydantic sorts them).

A failed validation raises ``ValidationError`` (a ``ValueError``), whose
``errors()`` lists dicts with pydantic's ``type``, ``loc``, ``msg`` and
``input`` (no ``url``)."""

import collections
import copy
import enum
import inspect
import json
import math
import types
import typing
from typing import Any, ClassVar

_MISSING = object()
_INVALID = object()


class ValidationError(ValueError):
    def __init__(self, title: str, errors: list[dict]):
        self.title = title
        self._errors = errors
        super().__init__(self._message())

    def errors(self) -> list[dict]:
        return [dict(e) for e in self._errors]

    def _message(self) -> str:
        n = len(self._errors)
        lines = [f"{n} validation error{'' if n == 1 else 's'} for {self.title}"]
        for e in self._errors:
            if e["loc"]:
                lines.append(".".join(str(p) for p in e["loc"]))
            lines.append(
                f"  {e['msg']} [type={e['type']}, input_value={e['input']!r}, "
                f"input_type={type(e['input']).__name__}]"
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self._message()


class FieldInfo:
    def __init__(
        self,
        default=_MISSING,
        *,
        default_factory=None,
        description=None,
        ge=None,
        le=None,
        exclude=None,
        validation_alias=None,
    ):
        self.default = default
        self.default_factory = default_factory
        self.description = description
        self.ge, self.le = ge, le
        self.exclude = exclude
        self.validation_alias = validation_alias
        self.annotation = None
        self.metadata: list = []

    def is_required(self) -> bool:
        return self.default is _MISSING and self.default_factory is None


def Field(default=_MISSING, **kwargs) -> Any:  # noqa: N802 - pydantic's name
    return FieldInfo(default, **kwargs)


def ConfigDict(**kwargs) -> dict:  # noqa: N802 - pydantic's name
    return dict(kwargs)


class _FieldValidator:
    def __init__(self, fields: tuple[str, ...], func):
        self.fields = fields
        self.func = func


def field_validator(*fields: str, mode: str = "after"):
    """An after-validator of ``fields``, stacked over a ``classmethod``."""
    if mode != "after":
        raise NotImplementedError(f"field_validator mode {mode!r}")

    def decorate(func):
        return _FieldValidator(fields, func)

    return decorate


# --- types ----------------------------------------------------------------


def _strip_annotated(tp):
    metadata = []
    while typing.get_origin(tp) is typing.Annotated:
        metadata.extend(tp.__metadata__)
        tp = tp.__origin__
    return tp, metadata


def _is_union(tp) -> bool:
    return typing.get_origin(tp) in (typing.Union, types.UnionType)


def _is_model(tp) -> bool:
    return isinstance(tp, type) and issubclass(tp, BaseModel)


def _is_enum(tp) -> bool:
    return isinstance(tp, type) and issubclass(tp, enum.Enum)


def _err(errors, type_, loc, msg, value, ctx=None):
    e = {"type": type_, "loc": tuple(loc), "msg": msg, "input": value}
    if ctx is not None:
        e["ctx"] = ctx
    errors.append(e)
    return _INVALID


def _choices(values) -> str:
    texts = [repr(v.value if isinstance(v, enum.Enum) else v) for v in values]
    if len(texts) == 1:
        return texts[0]
    return ", ".join(texts[:-1]) + " or " + texts[-1]


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "f", "false", "n", "no", "off"}


def _as_text(value):
    if isinstance(value, (bytes, bytearray)):
        try:
            return bytes(value).decode("utf-8")
        except UnicodeDecodeError:
            return None
    return value


def _float_from_text(text: str):
    try:
        return float(text.strip())
    except ValueError:
        return None


def _int_from_text(text: str):
    text = text.strip()
    try:
        return int(text)
    except ValueError:
        pass
    f = _float_from_text(text)
    if f is not None and math.isfinite(f) and f == int(f) and "." in text:
        return int(f)
    return None


def _validate_scalar(tp, value, loc, errors, strict):
    if tp is bool:
        if isinstance(value, bool):
            return value
        if strict:
            return _err(errors, "bool_type", loc, "Input should be a valid boolean", value)
        if isinstance(value, int) and value in (0, 1):
            return bool(value)
        if isinstance(value, float) and value in (0.0, 1.0):
            return bool(value)
        text = _as_text(value)
        if isinstance(text, str):
            if text.lower() in _TRUE:
                return True
            if text.lower() in _FALSE:
                return False
            return _err(errors, "bool_parsing", loc, "Input should be a valid boolean, unable to interpret input", value)
        if isinstance(value, int):
            return _err(errors, "bool_parsing", loc, "Input should be a valid boolean, unable to interpret input", value)
        return _err(errors, "bool_type", loc, "Input should be a valid boolean", value)
    if tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        if strict:
            return _err(errors, "int_type", loc, "Input should be a valid integer", value)
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, float):
            if not math.isfinite(value):
                return _err(errors, "finite_number", loc, "Input should be a finite number", value)
            if value != int(value):
                return _err(
                    errors, "int_from_float", loc,
                    "Input should be a valid integer, got a number with a fractional part", value,
                )
            if abs(value) >= 2**63:
                return _err(
                    errors, "int_parsing_size", loc,
                    "Unable to parse input string as an integer, exceeded maximum size", value,
                )
            return int(value)
        text = _as_text(value)
        if isinstance(text, str):
            parsed = _int_from_text(text)
            if parsed is None:
                return _err(
                    errors, "int_parsing", loc,
                    "Input should be a valid integer, unable to parse string as an integer", value,
                )
            return parsed
        return _err(errors, "int_type", loc, "Input should be a valid integer", value)
    if tp is float:
        if isinstance(value, float):
            return value
        if strict:
            if isinstance(value, int) and not isinstance(value, bool):
                return float(value)
            return _err(errors, "float_type", loc, "Input should be a valid number", value)
        if isinstance(value, int):
            return float(value)
        text = _as_text(value)
        if isinstance(text, str):
            parsed = _float_from_text(text)
            if parsed is None:
                return _err(
                    errors, "float_parsing", loc,
                    "Input should be a valid number, unable to parse string as a number", value,
                )
            return parsed
        return _err(errors, "float_type", loc, "Input should be a valid number", value)
    if tp is str:
        if isinstance(value, str):
            if isinstance(value, enum.Enum):
                return value.value if strict is False else value
            return value
        if not strict and isinstance(value, (bytes, bytearray)):
            text = _as_text(value)
            if text is not None:
                return text
            return _err(errors, "string_unicode", loc, "Input should be a valid string, unable to parse raw data as a unicode string", value)
        return _err(errors, "string_type", loc, "Input should be a valid string", value)
    raise TypeError(f"unsupported field type {tp!r}")


_SEQUENCE_INPUTS = (list, tuple, set, frozenset, collections.deque, range, type({}.keys()), type({}.values()))


def _union_tag(tp) -> str:
    tp, _ = _strip_annotated(tp)
    origin = typing.get_origin(tp)
    if origin is list or tp is list:
        args = typing.get_args(tp)
        return f"list[{_union_tag(args[0]) if args else 'any'}]"
    if origin is dict or tp is dict:
        args = typing.get_args(tp)
        return f"dict[{_union_tag(args[0])},{_union_tag(args[1])}]" if args else "dict[any,any]"
    if tp is Any:
        return "any"
    if origin is typing.Literal:
        return "literal[" + ",".join(repr(a) for a in typing.get_args(tp)) + "]"
    return getattr(tp, "__name__", repr(tp))


def _validate(tp, value, loc, errors, strict=False):
    """``value`` as ``tp`` (pydantic's lax mode unless ``strict``), or
    ``_INVALID`` with the failures appended to ``errors``."""
    tp, _ = _strip_annotated(tp)
    if tp is Any or tp is object:
        return value
    if tp is type(None) or tp is None:
        if value is None:
            return None
        return _err(errors, "none_required", loc, "Input should be None", value)
    if _is_union(tp):
        args = typing.get_args(tp)
        if type(None) in args:
            if value is None:
                return None
            args = tuple(a for a in args if a is not type(None))
        if len(args) == 1:
            return _validate(args[0], value, loc, errors, strict)
        for arg in args:
            out = _validate(arg, value, loc, [], strict=True)
            if out is not _INVALID:
                return out
        if not strict:
            member_errors: list = []
            for arg in args:
                out = _validate(arg, value, [*loc, _union_tag(arg)], member_errors)
                if out is not _INVALID:
                    return out
            errors.extend(member_errors)
            return _INVALID
        return _err(errors, "union_type", loc, "Input should be a valid value", value)
    origin = typing.get_origin(tp)
    if origin is typing.Literal:
        for allowed in typing.get_args(tp):
            if value == allowed and type(value) is type(allowed):
                return allowed
        return _err(
            errors, "literal_error", loc, f"Input should be {_choices(typing.get_args(tp))}", value,
            {"expected": _choices(typing.get_args(tp))},
        )
    if _is_model(tp):
        if isinstance(value, tp):
            return value
        if isinstance(value, dict):
            return tp._validate_dict(value, loc, errors)
        return _err(
            errors, "model_type", loc, f"Input should be a valid dictionary or instance of {tp.__name__}", value,
            {"class_name": tp.__name__},
        )
    if _is_enum(tp):
        if isinstance(value, tp):
            return value
        if not strict:
            candidate = _as_text(value) if issubclass(tp, str) else value
            for member in tp:
                if member.value == candidate and type(candidate) is type(member.value):
                    return member
        expected = _choices(list(tp))
        return _err(errors, "enum", loc, f"Input should be {expected}", value, {"expected": expected})
    if tp is list or origin is list:
        if isinstance(value, list) or (not strict and isinstance(value, _SEQUENCE_INPUTS)):
            args = typing.get_args(tp)
            if not args:
                return list(value)
            out, ok = [], True
            for i, item in enumerate(value):
                v = _validate(args[0], item, [*loc, i], errors, strict)
                ok = ok and v is not _INVALID
                out.append(v)
            return out if ok else _INVALID
        return _err(errors, "list_type", loc, "Input should be a valid list", value)
    if tp is dict or origin is dict:
        if isinstance(value, dict):
            args = typing.get_args(tp)
            if not args:
                return dict(value)
            out, ok = {}, True
            for k, v in value.items():
                kv = _validate(args[0], k, [*loc, k, "[key]"], errors, strict)
                vv = _validate(args[1], v, [*loc, k], errors, strict)
                ok = ok and kv is not _INVALID and vv is not _INVALID
                out[kv] = vv
            return out if ok else _INVALID
        return _err(errors, "dict_type", loc, "Input should be a valid dictionary", value)
    if tp in (bool, int, float, str):
        return _validate_scalar(tp, value, loc, errors, strict)
    raise TypeError(f"unsupported field type {tp!r}")


def _check_constraints(info: FieldInfo, value, loc, errors):
    for bound, kind, key, ok, word in (
        (info.ge, "greater_than_equal", "ge", lambda v, b: v >= b, "greater than or equal to"),
        (info.le, "less_than_equal", "le", lambda v, b: v <= b, "less than or equal to"),
    ):
        if bound is not None and isinstance(value, (int, float)) and not ok(value, bound):
            return _err(errors, kind, loc, f"Input should be {word} {bound}", value, {key: bound})
    return value


# --- the model --------------------------------------------------------------


class _ModelMeta(type):
    def __new__(mcs, name, bases, namespace, **kwargs):
        validators: dict[str, list] = {}
        for base in reversed(bases):
            for field, funcs in getattr(base, "__field_validators__", {}).items():
                validators.setdefault(field, []).extend(funcs)
        for attr, value in list(namespace.items()):
            if isinstance(value, _FieldValidator):
                func = value.func
                func = func.__func__ if isinstance(func, (classmethod, staticmethod)) else func
                for field in value.fields:
                    validators.setdefault(field, []).append(func)
                namespace[attr] = classmethod(func)
        config: dict = {}
        for base in reversed(bases):
            config.update(getattr(base, "model_config", {}))
        config.update(namespace.get("model_config", {}))
        namespace["model_config"] = config
        namespace["__field_validators__"] = validators
        own = namespace.get("__annotations__", {})
        defaults = {k: namespace.pop(k) for k in list(own) if k in namespace and not k.startswith("_")}
        cls = super().__new__(mcs, name, bases, namespace, **kwargs)
        fields: dict[str, FieldInfo] = {}
        for base in reversed(cls.__mro__[1:]):
            fields.update(getattr(base, "__model_fields__", {}))
        hints = typing.get_type_hints(cls, include_extras=True) if own else {}
        for key in own:
            hint = hints.get(key, own[key])
            if key.startswith("_") or typing.get_origin(hint) is ClassVar or hint is ClassVar:
                if key in defaults:
                    setattr(cls, key, defaults[key])
                continue
            default = defaults.get(key, _MISSING)
            info = copy.copy(default) if isinstance(default, FieldInfo) else FieldInfo(default)
            inner, metadata = _strip_annotated(hint)
            info.annotation = inner
            info.metadata = metadata
            fields[key] = info
        cls.__model_fields__ = fields
        return cls

    @property
    def model_fields(cls) -> dict[str, FieldInfo]:
        return cls.__model_fields__


def _dump_value(value, mode: str, exclude_unset: bool, exclude_none: bool):
    if isinstance(value, BaseModel):
        return value.model_dump(mode=mode, exclude_unset=exclude_unset, exclude_none=exclude_none)
    if isinstance(value, dict):
        return {
            _dump_value(k, mode, exclude_unset, exclude_none): _dump_value(v, mode, exclude_unset, exclude_none)
            for k, v in value.items()
        }
    if isinstance(value, (list, tuple, set, frozenset)):
        items = [_dump_value(v, mode, exclude_unset, exclude_none) for v in value]
        return items if mode == "json" or isinstance(value, list) else type(value)(items)
    if mode == "json" and isinstance(value, enum.Enum):
        return _dump_value(value.value, mode, exclude_unset, exclude_none)
    return value


def _float_json(v: float) -> str:
    """``v`` as serde_json (ryu) writes it, which pydantic's JSON uses."""
    if not math.isfinite(v):
        return "null"
    text = repr(v)
    sign = "-" if text.startswith("-") else ""
    text = text.lstrip("-")
    mantissa, _, exp = text.partition("e")
    whole, _, frac = mantissa.partition(".")
    digits = (whole + frac).lstrip("0")
    e = (int(exp) if exp else 0) - len(frac)
    if not digits:
        return sign + "0.0"
    stripped = digits.rstrip("0")
    e += len(digits) - len(stripped)
    digits = stripped
    n = len(digits)
    kk = n + e
    if 0 <= e and kk <= 16:
        return sign + digits + "0" * e + ".0"
    if 0 < kk <= 16:
        return sign + digits[:kk] + "." + digits[kk:]
    if -5 < kk <= 0:
        return sign + "0." + "0" * (-kk) + digits
    if n == 1:
        return f"{sign}{digits}e{kk - 1}"
    return f"{sign}{digits[0]}.{digits[1:]}e{kk - 1}"


def _json_text(value, indent: int | None, level: int = 0) -> str:
    if isinstance(value, float):
        return _float_json(value)
    if isinstance(value, dict):
        items = [(json.dumps(str(k), ensure_ascii=False), v) for k, v in value.items()]
        if not items:
            return "{}"
        if indent is None:
            return "{" + ",".join(f"{k}:{_json_text(v, None)}" for k, v in items) + "}"
        pad = "\n" + " " * (indent * (level + 1))
        body = ",".join(f"{pad}{k}: {_json_text(v, indent, level + 1)}" for k, v in items)
        return "{" + body + "\n" + " " * (indent * level) + "}"
    if isinstance(value, (list, tuple)):
        if not value:
            return "[]"
        if indent is None:
            return "[" + ",".join(_json_text(v, None) for v in value) + "]"
        pad = "\n" + " " * (indent * (level + 1))
        body = ",".join(f"{pad}{_json_text(v, indent, level + 1)}" for v in value)
        return "[" + body + "\n" + " " * (indent * level) + "]"
    return json.dumps(value, ensure_ascii=False)


class BaseModel(metaclass=_ModelMeta):
    model_config: ClassVar[dict] = {}

    def __init__(self, **data):
        errors: list = []
        state = type(self)._validated_state(data, [], errors)
        if errors:
            raise ValidationError(type(self).__name__, errors)
        object.__setattr__(self, "__dict__", state)

    # -- validation ------------------------------------------------------

    @classmethod
    def _validated_state(cls, data: dict, loc, errors) -> dict:
        state: dict = {}
        fields_set = set()
        extra_mode = cls.model_config.get("extra", "ignore")
        extra: dict = {}
        for name, info in cls.__model_fields__.items():
            key = info.validation_alias or name
            if key in data:
                fields_set.add(name)
                value = _validate(info.annotation, data[key], [*loc, key], errors)
                if value is not _INVALID:
                    value = _check_constraints(info, value, [*loc, key], errors)
                if value is not _INVALID:
                    for func in cls.__field_validators__.get(name, ()):
                        try:
                            value = func(cls, value)
                        except (ValueError, AssertionError) as e:
                            prefix = "Value error" if isinstance(e, ValueError) else "Assertion failed"
                            value = _err(errors, "value_error" if isinstance(e, ValueError) else "assertion_error",
                                         [*loc, key], f"{prefix}, {e}", data[key], {"error": e})
                            break
                state[name] = value
            elif info.is_required():
                _err(errors, "missing", [*loc, key], "Field required", data)
            elif info.default_factory is not None:
                state[name] = info.default_factory()
            else:
                default = info.default
                state[name] = copy.deepcopy(default) if isinstance(default, (dict, list, set)) else default
        known = {info.validation_alias or name for name, info in cls.__model_fields__.items()}
        for key, value in data.items():
            if key in known:
                continue
            if extra_mode == "forbid":
                _err(errors, "extra_forbidden", [*loc, key], "Extra inputs are not permitted", value)
            elif extra_mode == "allow":
                extra[key] = value
        state["__pydantic_fields_set__"] = fields_set
        state["__pydantic_extra__"] = extra if extra_mode == "allow" else None
        return state

    @classmethod
    def _validate_dict(cls, data: dict, loc, errors):
        n = len(errors)
        state = cls._validated_state(data, loc, errors)
        if len(errors) > n:
            return _INVALID
        obj = object.__new__(cls)
        object.__setattr__(obj, "__dict__", state)
        return obj

    @classmethod
    def model_validate(cls, obj):
        if isinstance(obj, cls):
            return obj
        errors: list = []
        if not isinstance(obj, dict):
            _err(errors, "model_type", [], f"Input should be a valid dictionary or instance of {cls.__name__}", obj,
                 {"class_name": cls.__name__})
            raise ValidationError(cls.__name__, errors)
        out = cls._validate_dict(obj, [], errors)
        if errors:
            raise ValidationError(cls.__name__, errors)
        return out

    # -- attributes --------------------------------------------------------

    @property
    def model_fields_set(self) -> set:
        return self.__dict__["__pydantic_fields_set__"]

    def __getattr__(self, name):
        extra = self.__dict__.get("__pydantic_extra__")
        if extra and name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def __setattr__(self, name, value):
        cls = type(self)
        if cls.model_config.get("frozen"):
            raise ValidationError(
                cls.__name__, [{"type": "frozen_instance", "loc": (name,), "msg": "Instance is frozen", "input": value}]
            )
        if name in cls.__model_fields__:
            self.__dict__[name] = value
            self.__dict__["__pydantic_fields_set__"].add(name)
        elif name.startswith("_"):
            object.__setattr__(self, name, value)
        elif self.__dict__.get("__pydantic_extra__") is not None:
            self.__dict__["__pydantic_extra__"][name] = value
        else:
            raise ValueError(f'"{cls.__name__}" object has no field "{name}"')

    def _field_items(self):
        for name in type(self).__model_fields__:
            yield name, self.__dict__[name]
        for item in (self.__dict__.get("__pydantic_extra__") or {}).items():
            yield item

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return dict(self._field_items()) == dict(other._field_items())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(f'{k}={v!r}' for k, v in self._field_items())})"

    def __copy__(self):
        new = object.__new__(type(self))
        state = dict(self.__dict__)
        state["__pydantic_fields_set__"] = set(state["__pydantic_fields_set__"])
        if state.get("__pydantic_extra__") is not None:
            state["__pydantic_extra__"] = dict(state["__pydantic_extra__"])
        object.__setattr__(new, "__dict__", state)
        return new

    def __deepcopy__(self, memo):
        new = object.__new__(type(self))
        object.__setattr__(new, "__dict__", copy.deepcopy(self.__dict__, memo))
        return new

    # -- serialization -----------------------------------------------------

    def model_dump(self, *, mode: str = "python", exclude_unset: bool = False, exclude_none: bool = False) -> dict:
        out: dict = {}
        fields_set = self.__dict__["__pydantic_fields_set__"]
        for name, info in type(self).__model_fields__.items():
            if info.exclude or (exclude_unset and name not in fields_set):
                continue
            value = self.__dict__[name]
            if exclude_none and value is None:
                continue
            out[name] = _dump_value(value, mode, exclude_unset, exclude_none)
        for name, value in (self.__dict__.get("__pydantic_extra__") or {}).items():
            if exclude_none and value is None:
                continue
            out[name] = _dump_value(value, mode, exclude_unset, exclude_none)
        return out

    def model_dump_json(self, *, indent: int | None = None, exclude_unset: bool = False,
                        exclude_none: bool = False) -> str:
        return _json_text(self.model_dump(mode="json", exclude_unset=exclude_unset, exclude_none=exclude_none), indent)

    @classmethod
    def model_json_schema(cls) -> dict:
        defs: dict = {}
        schema = _model_schema(cls, defs)
        if defs:
            schema["$defs"] = defs
        return _sort_schema(schema)


# --- JSON schema --------------------------------------------------------------


def _title_should_be_set(tp) -> bool:
    tp, _ = _strip_annotated(tp)
    if _is_union(tp):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return _title_should_be_set(args[0])
        return True
    return not (_is_model(tp) or _is_enum(tp))


def _type_schema(tp, defs: dict) -> dict:
    tp, _ = _strip_annotated(tp)
    if tp is Any or tp is object:
        return {}
    if tp is type(None) or tp is None:
        return {"type": "null"}
    if _is_union(tp):
        return {"anyOf": [_type_schema(a, defs) for a in typing.get_args(tp)]}
    origin = typing.get_origin(tp)
    if origin is typing.Literal:
        values = list(typing.get_args(tp))
        out: dict = {"enum": values} if len(values) > 1 else {"const": values[0], "enum": values}
        kinds = {type(v) for v in values}
        if kinds == {str}:
            out["type"] = "string"
        elif kinds == {int}:
            out["type"] = "integer"
        return out
    if _is_model(tp):
        if tp.__name__ not in defs:
            defs[tp.__name__] = None
            defs[tp.__name__] = _model_schema(tp, defs)
        return {"$ref": f"#/$defs/{tp.__name__}"}
    if _is_enum(tp):
        if tp.__name__ not in defs:
            values = [m.value for m in tp]
            schema: dict = {"enum": values, "title": tp.__name__}
            doc = tp.__dict__.get("__doc__")
            if doc:
                schema["description"] = inspect.cleandoc(doc)
            if all(isinstance(v, str) for v in values):
                schema["type"] = "string"
            elif all(isinstance(v, int) for v in values):
                schema["type"] = "integer"
            defs[tp.__name__] = schema
        return {"$ref": f"#/$defs/{tp.__name__}"}
    if tp is list or origin is list:
        args = typing.get_args(tp)
        return {"items": _type_schema(args[0], defs) if args else {}, "type": "array"}
    if tp is dict or origin is dict:
        args = typing.get_args(tp)
        values = _type_schema(args[1], defs) if args else {}
        return {"additionalProperties": values if values else True, "type": "object"}
    return {bool: {"type": "boolean"}, int: {"type": "integer"}, float: {"type": "number"},
            str: {"type": "string"}}[tp]


def _model_schema(cls, defs: dict) -> dict:
    properties: dict = {}
    required: list = []
    for name, info in cls.__model_fields__.items():
        prop = _type_schema(info.annotation, defs)
        if info.is_required():
            required.append(name)
        elif info.default_factory is None:
            prop["default"] = _dump_value(info.default, "json", False, False)
        if info.description is not None:
            prop["description"] = info.description
        if _title_should_be_set(info.annotation):
            prop["title"] = name.title().replace("_", " ")
        for bound, key in ((info.ge, "minimum"), (info.le, "maximum")):
            if bound is not None:
                prop[key] = bound
        properties[name] = prop
    schema: dict = {"properties": properties, "title": cls.__name__, "type": "object"}
    if required:
        schema["required"] = required
    extra = cls.model_config.get("extra")
    if extra == "forbid":
        schema["additionalProperties"] = False
    elif extra == "allow":
        schema["additionalProperties"] = True
    doc = cls.__dict__.get("__doc__")
    if doc:
        schema["description"] = inspect.cleandoc(doc)
    return schema


def _sort_schema(value, parent_key=None):
    """pydantic's key order: every mapping sorted, but for those directly
    under "properties" and "default", which keep their order."""
    if isinstance(value, dict):
        keys = value.keys() if parent_key in ("properties", "default") else sorted(value)
        return {k: _sort_schema(value[k], k) for k in keys}
    if isinstance(value, list):
        return [_sort_schema(v, parent_key) for v in value]
    return value
