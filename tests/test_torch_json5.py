"""The port's JSON5 reader (yolodl_torch/config/json5_reader.py) against the
``json5`` package the reference reads its configs with: every config of the
repo, and a table of snippets.  Results must be equal in value and type
(``repr``, so that NaN, -0.0 and int/float are told apart); error snippets
raise ValueError in both."""

import glob
import json
import os

import json5
import pytest

from yolodl_torch.config import json5_reader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "cfg", "**", "*.json5"), recursive=True))

VALID = [
    "{a: 1, b: 'two', c: \"three\"}",
    "{a: 1, a: 2, b: 3, a: 4}",               # duplicate keys: the last value wins
    "[1, 2, 3,]",
    "{a: 1,}",
    "{$a_b: 1, _c: 2, \\u0061d: 3, aé: 4, _\u200d: 5}",
    "{'single': 1, \"double\": 2}",
    "{Infinity: 1, null: 2, true: 3, NaN: 4}",  # reserved words as keys
    "// line comment\n{a: /* block */ 1} // after",
    "/* */ 1",
    "1 //",
    "0x1F", "-0x1f", "0XABCDEFabcdef",
    "+1", "-0", "-0.0", ".5", "5.", "-.5", "+.5e2", "1.e5", "1e3", "1E-2", "0e5",
    "1.5e400",
    "Infinity", "-Infinity", "+Infinity", "NaN", "+NaN", "-NaN",
    "9007199254740993",
    "\"a\\\nb\"", "\"a\\\r\nb\"", "\"a\\\u2028b\"",  # escaped line breaks
    "'it\\'s'", "\"say \\\"hi\\\"\"",
    "\"\\x41\\u0042\\0\\v\\q\\/\"",
    "\"\\ud83d\\ude00\"",
    "\"\t\"",
    "\ufeff 1", "\u00a0 1", "\u2003 1", "\n\r\n 1 \n",
    "true", "false", "null",
    "[true, false, null, [], {}]",
    "{a: {b: [1, {c: 2}]}, d: [[]]}",
    "\"\"", "''",
    "{\"a\":1}\n",
]

INVALID = [
    "", "  ", "01", "00", "[1 2]", "{a:}", "[,]", "[1,,2]", "{a:1}{b:2}",
    "NaNx", "Infinityx", "-", "- 1", "+-1", "--1", "0x", "-0x", "0x1.5", "0b1",
    "1e", "1e+", ".", "+.", ".e5", "1..2", "{1:2}", "{0x1:1}", "{\"a\" 1}",
    "{a b:1}", "{a-b:1}", "{a:1 b:2}", "\"a\nb\"", "\"a\u2028b\"", "1 /*",
    "\"\\1\"", "\"\\08\"", "\"\\u12\"", "\"\\x4\"", "tru", "nul", "truex",
    "\"abc", "'abc", "{", "[", "{a:1", "[1",
]


def same(a, b) -> bool:
    return repr(a) == repr(b) and type(a) is type(b)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_repo_configs_read_as_json5_reads_them(path):
    with open(path) as f:
        ref = json5.load(f)
    with open(path) as f:
        got = json5_reader.load(f)
    assert same(got, ref)


def test_every_repo_config_is_json5_not_json():
    """The stdlib json rejects the configs: the reader is needed."""
    assert len(CONFIGS) == 11
    for path in CONFIGS:
        with pytest.raises(ValueError):
            with open(path) as f:
                json.load(f)


@pytest.mark.parametrize("text", VALID)
def test_snippet(text):
    assert same(json5_reader.loads(text), json5.loads(text))


@pytest.mark.parametrize("text", INVALID)
def test_error_snippet(text):
    with pytest.raises(ValueError):
        json5.loads(text)
    with pytest.raises(ValueError):
        json5_reader.loads(text)


def test_error_names_line_and_column(tmp_path):
    path = tmp_path / "bad.json5"
    path.write_text("{\n  a: 1,\n  b: ?\n}\n")
    with pytest.raises(ValueError, match=r"bad\.json5:3:6: unexpected '\?'"):
        with open(path) as f:
            json5_reader.load(f)
    with pytest.raises(ValueError, match=r"<string>:1:3: unexpected end of input"):
        json5_reader.loads("[1")
