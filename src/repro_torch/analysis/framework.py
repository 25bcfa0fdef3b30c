"""Checker framework: registry, per-file visitor walk, suppressions, and the
run over the files (the port's copy of ``repro/analysis/framework.py``).

A checker subclasses :class:`Checker` and registers itself with
:func:`register`.  :func:`run_checks` parses every target file
once, hands each :class:`SourceFile` to every checker, filters findings
through inline ``simlint: ignore[rule] -- why`` comment suppressions, and
(``strict``) flags suppressions that carry no justification or suppress
nothing.

The reference's linter runs over the port too (the repository's own gate),
and in strict mode it calls a suppression of a rule it does not have
unused.  So a finding of a rule that only the port's checkers have
(:mod:`.dispatch`'s ``host-sync``, ``build-bypass``, ``f64``) is suppressed
with ``simlint-torch: ignore[rule] -- why``, which this framework reads and
the reference's does not; the shared rules keep ``simlint:``, which both
read.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

from .findings import Finding

__all__ = [
    "CheckConfig",
    "Checker",
    "SourceFile",
    "register",
    "registered_checkers",
    "run_checks",
]

# matches inline ``simlint: ignore[rule-a,rule-b] -- justification`` comments,
# and the port-only ``simlint-torch: ignore[...]`` form
_SUPPRESS_RE = re.compile(
    r"#\s*simlint(?:-torch)?:\s*ignore\[(?P<rules>[A-Za-z0-9_*,\- ]+)\]"
    r"(?:\s*--\s*(?P<why>\S.*))?"
)


@dataclasses.dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: Optional[str]
    used: bool = False

    def covers(self, rule: str) -> bool:
        return "*" in self.rules or rule in self.rules


class SourceFile:
    """One parsed target file: source text, AST, and its suppressions."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel  # repo-relative, used in findings
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        self.suppressions: Dict[int, Suppression] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = tuple(
                    r.strip() for r in m.group("rules").split(",") if r.strip()
                )
                self.suppressions[i] = Suppression(i, rules, m.group("why"))

    def finding(
        self, node: ast.AST, rule: str, message: str, checker: str = ""
    ) -> Finding:
        return Finding(
            path=self.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule=rule,
            message=message,
            checker=checker,
        )


# the analyzer's dispatch surfaces (core/analyzer.py)
_ANALYZER_SURFACES = (
    "_analyze_batch",
    "_sweep_cascades",
    "_sweep_reduce",
    "_analyze_fleet",
    "_analyze_pipeline",
)


@dataclasses.dataclass
class CheckConfig:
    """Tunable knobs; defaults encode the port's conventions."""

    # directories (relative, prefix match) never scanned — the seeded
    # violation corpus must not fail the repo run
    exclude: Tuple[str, ...] = ("tests/fixtures",)
    # simdim: dispatch-surface functions that must declare named-axis
    # contracts with @annotations.axes(...): the analyzer's five, the
    # kernel entry points of kernels/ops.py and kernels/congestion.py, and
    # the plain versions of kernels/ref.py that the lint names surfaces
    axes_required: Tuple[str, ...] = _ANALYZER_SURFACES + (
        "congestion_cascade",
        "chain_cascade",
        "congestion_queue",
        "qos_congestion_cascade",
        "ssd",
        "attention",
        "expand_events",
        "two_run_merge",
        "staging_sort",
        "qos_cascade_dyn",
    )
    # dispatch host-sync: the functions on the card's dispatch path, where
    # waiting for the card stalls the stream the attached program shares —
    # the analyzer's surfaces and the helpers they run, and the kernel
    # wrappers
    dispatch_surfaces: Tuple[str, ...] = _ANALYZER_SURFACES + (
        "_price",
        "_latency",
        "_bandwidth",
        "_host_sums",
        "_launch_groups",
        "congestion_cascade",
        "congestion_cascade_hosts",
        "congestion_scan",
        "chain_cascade",
        "congestion_queue",
        "qos_congestion_cascade",
        "qos_congestion_cascade_hosts",
        "ssd",
        "ssd_scan",
        "attention",
        "flash_attention",
        "expand_events",
    )
    # contracts: (impl file, summary-owning class, test file, test function)
    summary_contracts: Tuple[Tuple[str, str, str, str], ...] = (
        (
            "src/repro_torch/core/attach.py",
            "SimReport",
            "tests/test_torch_engine.py",
            "test_sim_report_summary_keys_locked",
        ),
        (
            "src/repro_torch/core/fabric.py",
            "FabricReport",
            "tests/test_torch_engine.py",
            "test_fabric_report_summary_keys_locked",
        ),
    )


class Checker:
    """Base class.  Subclasses set ``name`` + ``rules`` and implement
    :meth:`check_file`; repo-level (cross-file) checks go in
    :meth:`check_repo`, called once after every file was visited."""

    name: str = ""
    rules: Tuple[str, ...] = ()

    def check_file(
        self, sf: SourceFile, config: CheckConfig
    ) -> Iterable[Finding]:
        return ()

    def check_repo(
        self, files: Sequence[SourceFile], root: Path, config: CheckConfig
    ) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Type[Checker]] = {}


def register(cls: Type[Checker]) -> Type[Checker]:
    if not cls.name:
        raise ValueError(f"checker {cls.__name__} has no name")
    if cls.name in _REGISTRY and _REGISTRY[cls.name] is not cls:
        raise ValueError(f"checker name {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def registered_checkers() -> Dict[str, Type[Checker]]:
    return dict(_REGISTRY)


def _iter_files(paths: Sequence[Path], root: Path, config: CheckConfig):
    seen = set()
    for p in paths:
        candidates = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in candidates:
            try:
                rel = str(f.resolve().relative_to(root.resolve()))
            except ValueError:
                rel = str(f)
            if rel in seen:
                continue
            if any(
                rel == ex or rel.startswith(ex.rstrip("/") + "/")
                for ex in config.exclude
            ):
                continue
            seen.add(rel)
            yield f, rel


@dataclasses.dataclass
class CheckReport:
    findings: List[Finding]
    suppressed: List[Tuple[Finding, Suppression]]
    files_checked: int

    @property
    def ok(self) -> bool:
        return not self.findings


def run_checks(
    paths: Sequence[Path],
    root: Path,
    strict: bool = False,
    checker_names: Optional[Sequence[str]] = None,
    config: Optional[CheckConfig] = None,
) -> CheckReport:
    """Run the registered checkers over ``paths``; see the CLI in
    ``repro_torch.analysis.__main__``.

    ``strict`` additionally reports suppressions without a ``--``
    justification (``bare-suppression``) and suppressions that matched no
    finding (``unused-suppression``): nothing is silenced without a
    recorded reason.
    """
    config = config or CheckConfig()
    names = list(checker_names) if checker_names else sorted(_REGISTRY)
    checkers = [_REGISTRY[n]() for n in names]

    files: List[SourceFile] = []
    findings: List[Finding] = []
    for f, rel in _iter_files(paths, root, config):
        try:
            sf = SourceFile(f, rel, f.read_text())
        except SyntaxError as e:
            findings.append(
                Finding(rel, e.lineno or 1, 1, "parse-error", str(e), "framework")
            )
            continue
        files.append(sf)

    for checker in checkers:
        for sf in files:
            findings.extend(checker.check_file(sf, config))
        findings.extend(checker.check_repo(files, root, config))

    by_rel = {sf.rel: sf for sf in files}
    kept: List[Finding] = []
    suppressed: List[Tuple[Finding, Suppression]] = []
    for fi in findings:
        sf = by_rel.get(fi.path)
        sup = sf.suppressions.get(fi.line) if sf is not None else None
        if sup is not None and sup.covers(fi.rule):
            sup.used = True
            suppressed.append((fi, sup))
        else:
            kept.append(fi)

    if strict:
        for sf in files:
            for sup in sf.suppressions.values():
                if not sup.justification:
                    kept.append(
                        Finding(
                            sf.rel,
                            sup.line,
                            1,
                            "bare-suppression",
                            "suppression without a '-- justification'; "
                            "explain why the finding is safe to ignore",
                            "framework",
                        )
                    )
                if not sup.used:
                    kept.append(
                        Finding(
                            sf.rel,
                            sup.line,
                            1,
                            "unused-suppression",
                            f"suppression for {','.join(sup.rules)} matched "
                            "no finding; remove it",
                            "framework",
                        )
                    )
    return CheckReport(sorted(kept), suppressed, len(files))
