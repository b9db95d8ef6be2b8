"""The port's stand-ins for pydantic and PyYAML (``service/_model.py``,
``service/_yaml.py``) against the real packages, through the service's
own models.

- ``model_json_schema()`` of ``Configuration``, ``AppConfig``,
  ``RetrievalResponse``, ``IndexingResponse`` and ``ChatRequest`` equal to
  pydantic's, key order included.
- hypothesis-generated config and request dicts (lax values of every field
  type the models declare, wrong types, unknown keys): the port accepts
  and refuses exactly what pydantic does, with the same (type, loc) for
  each error, and its dumps (``mode="json"``, ``exclude_unset``,
  ``exclude_none``) and ``model_dump_json(indent=2)`` bytes equal.
- every case of tests/test_app_config.py through the port.
- ``_yaml.safe_load`` equal to ``yaml.safe_load`` on every config/*.yaml
  and on generated block mappings, and raising on input outside its
  subset (never a different value).
- ``load_app_config`` for every preset with env overrides: dumps equal.
"""

import enum
import json
import pathlib
import typing

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dial_rag_tpu.service import api as jax_api
from dial_rag_tpu.service import config as jax_config
from dial_rag_tpu.service import messages as jax_messages
from dial_rag_tpu_torch.service import _model, _yaml
from dial_rag_tpu_torch.service import api as port_api
from dial_rag_tpu_torch.service import config as port_config
from dial_rag_tpu_torch.service import messages as port_messages
from tests.utils.port_parity import twin_module

PRESETS = sorted((pathlib.Path(__file__).parent.parent / "config").glob("*.yaml"))
MODELS = {
    "Configuration": (jax_config.Configuration, port_config.Configuration),
    "AppConfig": (jax_config.AppConfig, port_config.AppConfig),
    "RetrievalResponse": (jax_api.RetrievalResponse, port_api.RetrievalResponse),
    "IndexingResponse": (jax_api.IndexingResponse, port_api.IndexingResponse),
    "ChatRequest": (jax_messages.ChatRequest, port_messages.ChatRequest),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_json_schema_equals_pydantic(name):
    ref, got = (m.model_json_schema() for m in MODELS[name])
    assert json.dumps(got) == json.dumps(ref)


# --- validation and dumps ---------------------------------------------------------

INTS = st.one_of(
    st.integers(-3, 3000),
    st.floats(allow_nan=True, allow_infinity=True),
    st.sampled_from(["5", " 7 ", "5.0", "5.5", "x", "1_000", "+3", "", "0x10"]),
    st.booleans(),
    st.none(),
)
FLOATS = st.one_of(
    st.floats(allow_nan=True, allow_infinity=True),
    st.integers(-5, 5),
    st.sampled_from(["1.5", "inf", "nan", "x", "1e3", " 2 ", "-0.25"]),
    st.booleans(),
    st.none(),
)
BOOLS = st.one_of(
    st.booleans(),
    st.sampled_from([0, 1, 2, -1, "true", "False", "yes", "off", "x", "1", "T", 1.0, 0.5, "", " on"]),
    st.none(),
)
STRS = st.one_of(st.text(max_size=4), st.integers(-2, 2), st.none(), st.sampled_from(["rrf", "float32", "é—"]))


def value_strategy(tp, depth: int = 0):
    """Good and bad values for a field of type ``tp``."""
    tp, _ = _model._strip_annotated(tp)
    if _model._is_union(tp):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return st.one_of(st.none(), *[value_strategy(a, depth) for a in args])
    origin = typing.get_origin(tp)
    if origin is typing.Literal:
        return st.one_of(st.sampled_from(typing.get_args(tp)), st.sampled_from(["borda", "RRF", 1, None]))
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return st.one_of(st.sampled_from([m.value for m in tp]), st.sampled_from(["RAG", "x", 0, None]))
    if isinstance(tp, type) and hasattr(tp, "model_fields"):
        return st.one_of(model_dicts(tp, depth + 1), st.sampled_from(["x", 3, []]))
    if tp is dict or origin is dict:
        args = typing.get_args(tp)
        if not args:
            return st.one_of(st.dictionaries(st.text(max_size=3), st.integers(), max_size=2), st.just([]))
        keys = st.sampled_from(list(jax_config.ENSEMBLE_ARMS) + ["other"])
        return st.one_of(st.dictionaries(keys, FLOATS, max_size=3), st.just([]), st.just({1: 2}))
    if tp is list or origin is list:
        return st.one_of(st.lists(st.integers(), max_size=2), st.just("ab"))
    return {int: INTS, float: FLOATS, bool: BOOLS, str: STRS}.get(tp, st.just(None))


def model_dicts(cls, depth: int = 0):
    """Dicts for pydantic model ``cls``: any subset of its fields, each a
    good or bad value, sometimes an unknown key."""
    fields = {} if depth > 3 else {name: value_strategy(f.annotation, depth) for name, f in cls.model_fields.items()}
    return st.fixed_dictionaries({}, optional={**fields, "no_such_field": st.integers()})


def outcome(cls, data: dict):
    try:
        model = cls.model_validate(data)
    except Exception as e:  # noqa: BLE001 - the refusal is compared
        assert type(e).__name__ == "ValidationError", e
        return ("refused", [(err["type"], err["loc"]) for err in e.errors()])
    dumps = [
        json.dumps(model.model_dump(mode="json", **kw))
        for kw in ({}, {"exclude_unset": True}, {"exclude_none": True}, {"exclude_unset": True, "exclude_none": True})
    ]
    python = json.dumps(model.model_dump(), default=lambda v: ("enum", v.value))
    return ("accepted", dumps, python, model.model_dump_json(), model.model_dump_json(indent=2))


def assert_same(name: str, data: dict):
    ref_cls, port_cls = MODELS[name]
    assert outcome(port_cls, data) == outcome(ref_cls, data), data


HYPOTHESIS = settings(max_examples=150, deadline=None, database=None, suppress_health_check=[HealthCheck.too_slow])


@HYPOTHESIS
@given(model_dicts(jax_config.Configuration))
def test_configuration_accepts_and_dumps_as_pydantic(data):
    assert_same("Configuration", data)


@HYPOTHESIS
@given(model_dicts(jax_config.AppConfig))
def test_app_config_accepts_and_dumps_as_pydantic(data):
    assert_same("AppConfig", data)


MESSAGES = st.lists(
    st.fixed_dictionaries(
        {"role": st.sampled_from(["user", "assistant", "system", "tool", "robot", 3])},
        optional={
            "content": st.one_of(st.text(max_size=5), st.none(), st.lists(st.integers(), max_size=2), st.integers()),
            "custom_content": st.one_of(
                st.none(),
                st.fixed_dictionaries(
                    {},
                    optional={
                        "attachments": st.one_of(st.none(), st.lists(st.fixed_dictionaries(
                            {}, optional={"url": STRS, "type": STRS, "title": STRS, "extra": st.integers()}),
                            max_size=2)),
                        "state": st.one_of(st.none(), st.integers(), st.text(max_size=3)),
                        "more": st.booleans(),
                    },
                ),
                st.just("x"),
            ),
            "name": st.text(max_size=3),
        },
    ),
    max_size=3,
)


@HYPOTHESIS
@given(st.fixed_dictionaries(
    {"messages": MESSAGES},
    optional={
        "stream": BOOLS,
        "custom_fields": st.one_of(st.none(), st.fixed_dictionaries(
            {}, optional={"configuration": st.one_of(st.none(), st.just({"a": 1}), st.just([])), "x": st.integers()})),
        "api_key": st.text(max_size=3),
        "model": st.text(max_size=3),
    },
))
def test_chat_request_accepts_and_dumps_as_pydantic(data):
    assert_same("ChatRequest", data)


def test_retrieval_response_bytes_equal_pydantic():
    chunks = [
        {"attachment_url": "files/b/é.pdf", "source": {"url": "files/b/é.pdf#page=2", "display_name": "é.pdf"},
         "text": "naïve — “quoted” \x01 text", "page": {"number": 2, "image_index": None}},
        {"attachment_url": "files/b/a.csv", "source": {"url": "files/b/a.csv"}, "text": None},
    ]
    data = {"chunks": chunks, "images": [{"data": "AAAA"}]}
    for name in ("RetrievalResponse",):
        assert_same(name, data)
    assert_same("IndexingResponse", {"indexing_result": {"files/b/x.pdf": {"errors": [{"message": "bad"}]}}})
    assert_same("RetrievalResponse", {"chunks": [{"source": {}}]})


def test_frozen_assignment_and_fields_set_match_pydantic():
    for pkg in (jax_config, port_config):
        config = pkg.AppConfig.model_validate({"dial_url": "http://x", "request": {"use_profiler": "yes"}})
        with pytest.raises(Exception) as info:
            config.dial_url = "http://mutate"
        assert type(info.value).__name__ == "ValidationError"
        assert config.model_fields_set == {"dial_url", "request"}
        assert config.request.model_fields_set == {"use_profiler"}
    ref = jax_messages.ChatRequest.model_validate({"messages": []})
    got = port_messages.ChatRequest.model_validate({"messages": []})
    ref.api_key = got.api_key = "k"
    assert ref.model_fields_set == got.model_fields_set == {"messages", "api_key"}
    assert got.model_dump() == ref.model_dump() == {"messages": [], "stream": False, "custom_fields": None}


@pytest.mark.parametrize("value", [0.0, 1e-5, 1e-6, 1.5e16, 1e15, 123456789012345678.0, 5e-324, -0.0, 0.1, 2.5e-320,
                                   float("inf"), float("nan"), 1e21, -3.25e-7, 1234.5])
def test_float_json_equals_pydantic(value):
    ref = jax_config.LlmConfig(temperature=value).model_dump_json()
    assert port_config.LlmConfig(temperature=value).model_dump_json() == ref


@HYPOTHESIS
@given(st.floats(allow_nan=False))
def test_float_json_equals_pydantic_on_any_float(value):
    ref = jax_config.LlmConfig(temperature=value).model_dump_json()
    assert port_config.LlmConfig(temperature=value).model_dump_json() == ref


APP_CONFIG_CASES = [
    n for n in dir(__import__("tests.test_app_config", fromlist=["x"])) if n.startswith("test_")
]


@pytest.mark.parametrize("case", APP_CONFIG_CASES)
def test_app_config_case_through_the_port(case, tmp_path):
    twin = twin_module("test_app_config", (
        ("    import pydantic\n", "    from dial_rag_tpu_torch.service import _model as pydantic\n"),
    ))
    fn = getattr(twin, case)
    fn(tmp_path) if fn.__code__.co_argcount else fn()


def test_invalid_configuration_is_the_one_intended_difference():
    """``validate_custom_configuration`` raises the same 400 in both
    packages; the text after "Invalid configuration: " is each package's
    ``errors()``, the same (type, loc) pairs."""
    bad = {"retrieval": {"fusion_method": "borda", "fusion_depth": 0}, "no_such_field": 1}
    errors = {}
    for pkg, errors_mod in ((jax_config, "dial_rag_tpu.errors"), (port_config, "dial_rag_tpu_torch.errors")):
        with pytest.raises(Exception) as info:
            pkg.validate_custom_configuration(bad)
        e = info.value
        assert type(e).__name__ == "InvalidConfigurationError" and type(e).__module__ == errors_mod
        assert e.status_code == 400 and e.message.startswith("Invalid configuration: [")
        errors[pkg] = [(err["type"], err["loc"]) for err in e.__cause__.errors()]
    assert errors[port_config] == errors[jax_config] == [
        ("literal_error", ("retrieval", "fusion_method")),
        ("greater_than_equal", ("retrieval", "fusion_depth")),
        ("extra_forbidden", ("no_such_field",)),
    ]
    assert port_config.validate_custom_configuration({"retrieval": {"fusion_depth": "5"}}) == {
        "retrieval": {"fusion_depth": "5"}
    }


# --- YAML ---------------------------------------------------------------------


@pytest.mark.parametrize("path", PRESETS, ids=lambda p: p.name)
def test_yaml_presets_equal_pyyaml(path):
    text = path.read_text()
    assert _yaml.safe_load(text) == yaml.safe_load(text)
    with open(path) as f:
        assert _yaml.safe_load(f) == yaml.safe_load(text)


OUTSIDE = [
    "a:\n  - 1\n  - 2\n",
    "a: [1, 2]\n",
    "a: {b: 1}\n",
    "a: &x 1\nb: *x\n",
    "a: !!str 1\n",
    "a: |\n  text\n",
    "a: >\n  text\n",
    "a: plain\n  continued\n",
    "a: 017\n",
    "a: 0x1F\n",
    "a: 0b101\n",
    "a: 1:30\n",
    "a: 2024-01-02\n",
    "---\na: 1\n",
    "a:\n\tb: 1\n",
    "a: 'open\n",
    "a: b: c\n",
    "? a\n: b\n",
    "- a\n",
    "a:\n    b: 1\n  c: 2\n",
    "a: \"\\x41\"\n",
    "1: a\n",
    "a: 1\n b: 2\n",
]


@pytest.mark.parametrize("text", OUTSIDE)
def test_yaml_refuses_outside_the_subset(text):
    with pytest.raises(_yaml.YAMLError):
        _yaml.safe_load(text)


INSIDE = [
    ("", None),
    ("# only a comment\n", None),
    ("a: {}\nb: { }\n", {"a": {}, "b": {}}),
    ("a: null\nb: ~\nc:\nd: Null\n", {"a": None, "b": None, "c": None, "d": None}),
    ("a: yes\nb: Off\nc: TRUE\nd: 'true'\n", {"a": True, "b": False, "c": True, "d": "true"}),
    ("a: 1_000\nb: -0\nc: 1.5\nd: 1e3\ne: .5\nf: 1.0e+3\n",
     {"a": 1000, "b": 0, "c": 1.5, "d": "1e3", "e": 0.5, "f": 1000.0}),
    ("a: \"x # y\"  # c\nb: 'it''s'\nc: x#y\n", {"a": "x # y", "b": "it's", "c": "x#y"}),
    ("a:\n  b:\n    c: 1\n  d: 2\ne: 3\n", {"a": {"b": {"c": 1}, "d": 2}, "e": 3}),
    ("a: http://host:80/x\n", {"a": "http://host:80/x"}),
    ("a: \"é\\u00e9\\n\"\n", {"a": "éé\n"}),
    ("a: .inf\nb: -.Inf\n", {"a": float("inf"), "b": float("-inf")}),
    ("a: 0o17\n", {"a": "0o17"}),
]


@pytest.mark.parametrize("text,value", INSIDE)
def test_yaml_subset_values(text, value):
    assert yaml.safe_load(text) == value
    assert _yaml.safe_load(text) == value


SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-10**6, 10**6),
    st.floats(allow_nan=False, allow_infinity=False),
    st.text(alphabet=st.characters(blacklist_categories=("Cs", "Cc")), max_size=8),
    st.sampled_from(["yes", "no", "on", "null", "~", "1.5", "1e3", "0o7", "012", "a: b", "#x", "x #y", "- a",
                     "2024-01-01", "{}", ""]),
)
MAPPINGS = st.recursive(
    st.dictionaries(st.text(alphabet="abcxyz_", min_size=1, max_size=4), SCALARS, max_size=4),
    lambda inner: st.dictionaries(st.text(alphabet="abcxyz_", min_size=1, max_size=4), inner, min_size=1,
                                  max_size=3),
    max_leaves=12,
)


@HYPOTHESIS
@given(MAPPINGS, st.sampled_from([{}, {"default_flow_style": False}, {"default_style": '"'},
                                  {"default_style": "'"}, {"width": 10}]))
def test_yaml_equals_pyyaml_or_refuses(value, options):
    """On PyYAML's own dumps of generated mappings, the port reads the
    same value or raises; it never reads a different one."""
    text = yaml.safe_dump(value, **options)
    ref = yaml.safe_load(text)
    try:
        got = _yaml.safe_load(text)
    except _yaml.YAMLError:
        return
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True), text


# --- the loader -----------------------------------------------------------------

ENV_OVERRIDES = [  # (env, whether the loader refuses it)
    ({}, False),
    ({"DIAL_URL": "http://core:8080", "ENABLE_DEBUG_COMMANDS": "true"}, False),
    ({"DIAL_RAG__EMBEDDER__BATCH_SIZE": "64", "DIAL_RAG__INDEX_STORAGE__USE_DIAL_FILE_STORAGE": "false",
      "DIAL_RAG__REQUEST__RETRIEVAL__FUSION_DEPTH": "12", "DIAL_RAG__PARALLEL__DATA_PARALLEL": "False"}, False),
    ({"DIAL_RAG__REQUEST__QA_CHAIN__CHAT_CHAIN__NUM_PAGE_IMAGES_TO_USE": "0",
      "DIAL_RAG__REQUEST__INDEXING__PARSER__CHUNK_SIZE": "500"}, False),
    ({"DIAL_RAG__REQUEST__REQUEST__TYPE": "indexing"}, True),
    ({"DIAL_RAG__REQUEST__RETRIEVAL__FUSION_METHOD": "borda"}, True),
]


@pytest.mark.parametrize("env,refused", ENV_OVERRIDES)
@pytest.mark.parametrize("path", PRESETS, ids=lambda p: p.name)
def test_load_app_config_matches_jax(path, env, refused):
    environ = {"DIAL_RAG__CONFIG_PATH": str(path), **env}
    results = []
    for pkg in (jax_config, port_config):
        try:
            config = pkg.load_app_config(environ=environ)
        except Exception as e:  # noqa: BLE001 - the refusal is compared
            results.append(("refused", type(e).__name__, [(err["type"], err["loc"]) for err in e.errors()]))
            continue
        results.append((
            json.dumps(config.model_dump(mode="json")),
            json.dumps(config.model_dump(mode="json", exclude_unset=True)),
            json.dumps(config.request.model_dump(exclude_unset=True), default=lambda v: v.value),
            config.model_dump_json(indent=2),
        ))
    assert results[1] == results[0]
    assert (results[0][0] == "refused") == refused
