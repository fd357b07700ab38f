"""The port's copies of the JAX package's operator tools and analysis
modules whose text must differ from the reference's in a few strings:

  * `tools.timeline`, `tools.doctor`, `tools.top` print their command
    (`argparse` `prog=`): the port's names `dragonboat_tpu_torch.tools.*`.
    Their code tokens equal the reference's once `dragonboat_tpu.` is
    mapped to `dragonboat_tpu_torch.` in string literals only.
  * `analysis.engine` keeps the reference's code tokens (only its
    docstrings differ); it is not in `COPIED` of test_torch_host_copies
    because its `_PKG_ROOT` names each package's own directory.
  * `analysis.rules_hotpath`, `rules_locks`, `rules_xlocks`: the same
    code once each rule's `motivation` text is set aside (the port's
    says why without the reference's project history).
  * `tools.longhaul`: the mapped code once the port's `device` and
    `rtt_ms` options are set aside (their `Options` fields,
    `EngineConfig(device=...)` and `rtt_millisecond=opts.rtt_ms` in
    `_mk_host`, `--device` and `--rtt-ms` in the replay line when not the
    defaults, the two flags of `main`).

None of them mentions jax, and their constant tables equal the
reference's."""
import ast
import importlib
import io
import os
import tokenize

import pytest

import dragonboat_tpu_torch

PORT = os.path.dirname(dragonboat_tpu_torch.__file__)
REF = os.path.join(os.path.dirname(PORT), "dragonboat_tpu")

MAPPED = ("tools.timeline", "tools.doctor", "tools.top", "analysis.engine")
RULE_COPIES = ("analysis.rules_hotpath", "analysis.rules_locks", "analysis.rules_xlocks")
# a path: each package's own directory, not a table
PER_PACKAGE = {"_PKG_ROOT"}


def source_path(root, name):
    p = os.path.join(root, *name.split("."))
    return p + "/__init__.py" if os.path.isdir(p) else p + ".py"


def _map(text: str) -> str:
    return text.replace("dragonboat_tpu.", "dragonboat_tpu_torch.")


def code_tokens(path, map_strings=False, source=None):
    """The code tokens of a source file (or of `source`, its text): no
    comments, no docstrings; with `map_strings`, `dragonboat_tpu.` mapped
    in string literals and in the literal text of f-strings."""
    strings = {tokenize.STRING, getattr(tokenize, "FSTRING_MIDDLE", tokenize.STRING)}
    if source is None:
        with open(path) as f:
            source = f.read()
    out, prev = [], None
    for t in tokenize.generate_tokens(io.StringIO(source).readline):
        if t.type in (tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE,
                      tokenize.INDENT, tokenize.DEDENT):
            prev = t.type if t.type != tokenize.COMMENT else prev
            continue
        # a string standing alone as a statement is a docstring
        if t.type == tokenize.STRING and prev in (
                None, tokenize.NEWLINE, tokenize.INDENT, tokenize.DEDENT):
            prev = tokenize.NEWLINE
            continue
        s = t.string
        if map_strings and t.type in strings:
            s = _map(s)
        out.append(s)
        prev = t.type
    return out


def code_without_motivation(path) -> str:
    """The module's AST without docstrings and with every class-level
    `motivation = ...` value blanked."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and [getattr(t, "id", None) for t in stmt.targets] == ["motivation"]):
                    stmt.value = ast.Constant("")
    return ast.dump(tree)


@pytest.mark.parametrize("name", MAPPED)
def test_mapped_copy_keeps_the_reference_code(name):
    port = code_tokens(source_path(PORT, name))
    assert port == code_tokens(source_path(REF, name), map_strings=True)


@pytest.mark.parametrize("name", MAPPED[:3])
def test_mapped_copy_names_the_port_command(name):
    with open(source_path(PORT, name)) as f:
        src = f.read()
    short = name.split(".")[-1]
    assert f'prog="python -m dragonboat_tpu_torch.tools.{short}"' in src
    assert "python -m dragonboat_tpu.tools" not in src


@pytest.mark.parametrize("name", RULE_COPIES)
def test_rule_copy_keeps_the_reference_code(name):
    assert code_without_motivation(source_path(PORT, name)) == \
        code_without_motivation(source_path(REF, name))


@pytest.mark.parametrize("name", RULE_COPIES)
def test_rule_copy_keeps_rule_ids_and_docs(name):
    ref = importlib.import_module("dragonboat_tpu." + name)
    port = importlib.import_module("dragonboat_tpu_torch." + name)
    assert [(r.id, r.doc) for r in port.RULES] == [(r.id, r.doc) for r in ref.RULES]
    assert all(r.motivation for r in port.RULES)


@pytest.mark.parametrize("name", MAPPED + RULE_COPIES)
def test_mapped_copy_never_mentions_jax(name):
    with open(source_path(PORT, name)) as f:
        assert "jax" not in f.read().lower(), name


def _constants(mod):
    return {
        k: v for k, v in vars(mod).items()
        if k.isupper() and k not in PER_PACKAGE
        and isinstance(v, (int, str, bytes, float, frozenset, tuple))
    }


@pytest.mark.parametrize("name", MAPPED + RULE_COPIES)
def test_mapped_copy_constant_tables_equal(name):
    ref = importlib.import_module("dragonboat_tpu." + name)
    port = importlib.import_module("dragonboat_tpu_torch." + name)
    assert _constants(port) == _constants(ref)


# the only code tools.longhaul adds to the reference's: its `device` and
# `rtt_ms` options
LONGHAUL_OPTION_LINES = (
    '    device: str = "cuda"\n',
    "            device=opts.device,\n",
    '        if self.opts.device != "cuda":\n'
    '            cmd += f" --device {self.opts.device}"\n',
    '    ap.add_argument("--device", default="cuda",\n'
    '                    help="the vector engine\'s device (default cuda; cpu "\n'
    '                         "runs the plain PyTorch step)")\n',
    "            device=args.device,\n",
    "    rtt_ms: int = 5\n",
    '        if self.opts.rtt_ms != 5:\n'
    '            cmd += f" --rtt-ms {self.opts.rtt_ms}"\n',
    '    ap.add_argument("--rtt-ms", type=int, default=5,\n'
    '                    help="the hosts\' tick in ms (default 5)")\n',
    "            rtt_ms=args.rtt_ms,\n",
)


def test_longhaul_copy_keeps_the_reference_code_but_its_device_and_tick():
    with open(source_path(PORT, "tools.longhaul")) as f:
        src = f.read()
    for line in LONGHAUL_OPTION_LINES:
        assert src.count(line) == 1, line
        src = src.replace(line, "")
    # the reference's tick is the constant the port's option defaults to
    src = src.replace("rtt_millisecond=opts.rtt_ms,", "rtt_millisecond=5,")
    ref = code_tokens(source_path(REF, "tools.longhaul"), map_strings=True)
    assert code_tokens(None, source=src) == ref


def test_longhaul_copy_names_the_port_command():
    with open(source_path(PORT, "tools.longhaul")) as f:
        src = f.read()
    assert 'prog="python -m dragonboat_tpu_torch.tools.longhaul"' in src
    assert "dragonboat_tpu.tools" not in src
    assert "jax" not in src.lower()


def test_longhaul_copy_constant_tables_equal():
    ref = importlib.import_module("dragonboat_tpu.tools.longhaul")
    port = importlib.import_module("dragonboat_tpu_torch.tools.longhaul")
    assert _constants(port) == _constants(ref)
