"""Best-effort stdlib lint gate for environments without ruff.

The repo's real gate is ruff (``pyproject.toml [tool.ruff]``: E, F, W,
I, S, C90 at line-length 80) run by CI and pre-commit. The build
environment for this project cannot install packages, so this script
re-implements the mechanically-checkable subset with ast/tokenize only
and is run as ``python tools/minilint.py`` to keep a recorded clean
run. It intentionally under-approximates ruff — rules
needing full name resolution (undefined names, import sorting) are out
of scope — so a clean minilint run does NOT guarantee a clean ruff run,
but every finding it DOES emit is a real one.

Checks:
  E501  line longer than 80 (urls and ``# noqa`` lines exempt)
  E722  bare ``except:``
  W291/W293  trailing whitespace
  W292  missing newline at end of file
  F401  unused import (module scope; ``__init__.py`` exempt — re-export
        surface)
  F811  top-level redefinition of a function/class
  S102/S307  use of ``exec`` / ``eval``
  C901  cyclomatic complexity > 15 (mccabe-style branch count)
  SPELL a small high-confidence typo list (codespell-lite; the real
        codespell config is ``.codespellrc``)
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

MAX_LINE = 80
MAX_COMPLEXITY = 15
TYPOS = {
    "teh", "recieve", "seperate", "occured", "definately", "adress",
    "paramter", "paramters", "covarience", "guage", "lenght", "widht",
    "neccessary", "accross", "untill", "wich", "reciever", "existant",
    "compatability", "explict", "dimenion", "funtion", "retured",
}

ROOTS = ("glomargridding_jax", "tests", "examples", "tools")
TOP_FILES = ("bench.py", "bench_reference_configs.py",
             "__graft_entry__.py", "setup_native.py")


def iter_files(repo: Path):
    for root in ROOTS:
        yield from sorted((repo / root).rglob("*.py"))
    for name in TOP_FILES:
        p = repo / name
        if p.exists():
            yield p


def check_lines(path: Path, text: str, findings: list):
    lines = text.split("\n")
    for i, line in enumerate(lines, 1):
        if len(line) > MAX_LINE and "noqa" not in line \
                and "http" not in line:
            findings.append((path, i, f"E501 line too long ({len(line)})"))
        if line != line.rstrip():
            code = "W293" if not line.strip() else "W291"
            findings.append((path, i, f"{code} trailing whitespace"))
    if text and not text.endswith("\n"):
        findings.append((path, len(lines), "W292 no newline at EOF"))


class Complexity(ast.NodeVisitor):
    def __init__(self):
        self.score = 1

    def visit(self, node):
        if isinstance(node, (ast.If, ast.For, ast.While, ast.Assert,
                             ast.AsyncFor, ast.IfExp)):
            self.score += 1
        elif isinstance(node, ast.BoolOp):
            self.score += len(node.values) - 1
        elif isinstance(node, ast.ExceptHandler):
            self.score += 1
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            self.score += sum(
                1 + len(g.ifs) for g in node.generators
            )
        super().generic_visit(node)


def _module_imports(tree: ast.Module) -> dict[str, int]:
    """name -> lineno for module-scope imports (``__future__`` exempt)."""
    imported: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                imported[(a.asname or a.name).split(".")[0]] = node.lineno
        elif isinstance(node, ast.ImportFrom) \
                and node.module != "__future__":
            for a in node.names:
                if a.name != "*":
                    imported[a.asname or a.name] = node.lineno
    return imported


def _check_unused_imports(path: Path, tree: ast.Module, findings: list):
    """F401 at module scope; ``__init__.py`` is a re-export surface."""
    if path.name == "__init__.py":
        return
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(
            node.value, str
        ):
            used.add(node.value)  # __all__ strings count as used
    for name, lineno in _module_imports(tree).items():
        if name not in used:
            findings.append(
                (path, lineno, f"F401 unused import '{name}'")
            )


def _check_redefinitions(path: Path, tree: ast.Module, findings: list):
    """F811 top-level function/class redefinitions."""
    seen: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if node.name in seen:
                findings.append((
                    path, node.lineno,
                    f"F811 redefinition of '{node.name}' "
                    f"(first at line {seen[node.name]})",
                ))
            seen[node.name] = node.lineno


def _check_nodes(path: Path, tree: ast.Module, findings: list):
    """E722 bare except, S102/S307 exec/eval, C901 complexity."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append((path, node.lineno, "E722 bare except"))
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Name
        ) and node.func.id in ("exec", "eval"):
            findings.append((
                path, node.lineno,
                f"S102/S307 use of {node.func.id}()",
            ))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            c = Complexity()
            for stmt in node.body:
                c.visit(stmt)
            if c.score > MAX_COMPLEXITY:
                findings.append((
                    path, node.lineno,
                    f"C901 '{node.name}' too complex ({c.score} > "
                    f"{MAX_COMPLEXITY})",
                ))


def check_ast(path: Path, tree: ast.Module, findings: list):
    _check_unused_imports(path, tree, findings)
    _check_redefinitions(path, tree, findings)
    _check_nodes(path, tree, findings)


def check_spelling(path: Path, text: str, findings: list):
    import re

    if path.name == "minilint.py":  # the wordlist lives here
        return
    for i, line in enumerate(text.split("\n"), 1):
        for word in re.findall(r"[A-Za-z]+", line):
            if word.lower() in TYPOS:
                findings.append((path, i, f"SPELL '{word}'"))


def _drop_noqa(path: Path, text: str, findings: list) -> list:
    """Suppress findings whose source line carries ``# noqa`` (bare, or
    listing this finding's code) — ruff's own escape-hatch semantics."""
    lines = text.split("\n")
    kept = []
    for f in findings:
        _, lineno, msg = f
        line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        if "noqa" in line:
            after = line.split("noqa", 1)[1]
            code = msg.split()[0].split("/")[0]
            if ":" not in after or code in after:
                continue
        kept.append(f)
    return kept


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    findings: list = []
    n_files = 0
    for path in iter_files(repo):
        n_files += 1
        text = path.read_text()
        file_findings: list = []
        check_lines(path, text, file_findings)
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as e:
            file_findings.append((path, e.lineno or 0, f"E999 {e.msg}"))
        else:
            check_ast(path, tree, file_findings)
            check_spelling(path, text, file_findings)
        findings.extend(_drop_noqa(path, text, file_findings))

    for path, lineno, msg in findings:
        rel = path.relative_to(repo)
        print(f"{rel}:{lineno}: {msg}")
    print(
        f"minilint: {n_files} files, {len(findings)} findings",
        file=sys.stderr,
    )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
