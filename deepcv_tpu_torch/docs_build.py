"""Static HTML docs builder: ``docs/*.md``, ``README.md`` and ``PARITY.md``
rendered with a shared nav bar and an index, by a dependency-free Markdown
converter.

Counterpart of ``deepcv_tpu/docs_build.py`` (``md_to_html``,
``build_docs``), copied: the same pages, byte for byte. The converter
covers the Markdown this repo's docs use: ATX headings, fenced code blocks,
inline code, bold and italic, links (``.md`` targets become ``.html``),
ordered and unordered lists, blockquotes, tables and horizontal rules.
``python -m deepcv_tpu_torch docs [--out docs/_build]`` runs it.
"""
from __future__ import annotations

import html
import re
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["md_to_html", "build_docs"]

_PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>{title}</title>
<style>
body {{ font: 15px/1.6 system-ui, sans-serif; max-width: 60em;
       margin: 2em auto; padding: 0 1em; color: #1a1a1a; }}
nav {{ border-bottom: 1px solid #ddd; padding-bottom: .6em;
      margin-bottom: 1.5em; }}
nav a {{ margin-right: 1.2em; text-decoration: none; color: #0b5dd6; }}
pre {{ background: #f6f8fa; padding: .8em; overflow-x: auto;
      border-radius: 6px; }}
code {{ background: #f6f8fa; padding: .1em .3em; border-radius: 4px;
       font-size: .92em; }}
pre code {{ padding: 0; background: none; }}
table {{ border-collapse: collapse; }}
th, td {{ border: 1px solid #ccc; padding: .3em .6em; }}
blockquote {{ border-left: 4px solid #ddd; margin-left: 0;
             padding-left: 1em; color: #555; }}
h1, h2, h3 {{ line-height: 1.25; }}
</style></head>
<body><nav>{nav}</nav>
{body}
</body></html>
"""


def _inline(text: str) -> str:
    """Inline markdown on an already-HTML-escaped line."""
    text = re.sub(r"`([^`]+)`", r"<code>\1</code>", text)
    text = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", text)
    text = re.sub(r"(?<!\w)\*([^*\s][^*]*)\*", r"<em>\1</em>", text)
    text = re.sub(r"\[([^\]]+)\]\(([^)\s]+)\)",
                  lambda m: '<a href="%s">%s</a>' % (
                      re.sub(r"\.md$", ".html", m.group(2)), m.group(1)),
                  text)
    return text


def md_to_html(md: str) -> str:
    """Markdown body -> HTML body (see module docstring for coverage)."""
    out: List[str] = []
    lines = md.splitlines()
    i, n = 0, len(lines)
    para: List[str] = []
    lists: List[str] = []          # stack of open list tags

    def flush_para():
        if para:
            out.append("<p>" + _inline(" ".join(para)) + "</p>")
            para.clear()

    def close_lists(depth: int = 0):
        while len(lists) > depth:
            out.append(f"</{lists.pop()}>")

    while i < n:
        raw = lines[i]
        line = raw.rstrip()
        stripped = line.strip()
        if stripped.startswith("```"):
            flush_para()
            close_lists()
            i += 1
            block: List[str] = []
            while i < n and not lines[i].strip().startswith("```"):
                block.append(lines[i])
                i += 1
            out.append("<pre><code>" + html.escape("\n".join(block))
                       + "</code></pre>")
            i += 1
            continue
        esc = html.escape(stripped)
        m = re.match(r"(#{1,6})\s+(.*)", stripped)
        if m:
            flush_para()
            close_lists()
            lvl = len(m.group(1))
            out.append(f"<h{lvl}>{_inline(html.escape(m.group(2)))}</h{lvl}>")
        elif re.fullmatch(r"(-{3,}|\*{3,}|_{3,})", stripped):
            flush_para()
            close_lists()
            out.append("<hr>")
        elif stripped.startswith("|") and stripped.endswith("|"):
            flush_para()
            close_lists()
            rows: List[List[str]] = []
            while i < n and lines[i].strip().startswith("|"):
                cells = [c.strip() for c in
                         lines[i].strip().strip("|").split("|")]
                if not all(re.fullmatch(r":?-{2,}:?", c) for c in cells):
                    rows.append(cells)
                i += 1
            if rows:
                tr = ["<tr>" + "".join(
                    f"<{'th' if r == 0 else 'td'}>"
                    f"{_inline(html.escape(c))}"
                    f"</{'th' if r == 0 else 'td'}>" for c in row) + "</tr>"
                    for r, row in enumerate(rows)]
                out.append("<table>" + "".join(tr) + "</table>")
            continue
        elif stripped.startswith(">"):
            flush_para()
            close_lists()
            quote = []
            while i < n and lines[i].strip().startswith(">"):
                quote.append(lines[i].strip().lstrip("> "))
                i += 1
            out.append("<blockquote><p>"
                       + _inline(html.escape(" ".join(quote)))
                       + "</p></blockquote>")
            continue
        elif re.match(r"([-*+]|\d+\.)\s+", stripped):
            flush_para()
            indent = len(raw) - len(raw.lstrip())
            depth = indent // 2 + 1
            tag = "ol" if re.match(r"\d+\.", stripped) else "ul"
            while len(lists) > depth:
                out.append(f"</{lists.pop()}>")
            while len(lists) < depth:
                lists.append(tag)
                out.append(f"<{tag}>")
            item = re.sub(r"^([-*+]|\d+\.)\s+", "", stripped)
            out.append("<li>" + _inline(html.escape(item)) + "</li>")
        elif not stripped:
            flush_para()
            close_lists()
        else:
            if lists:
                # continuation line of a list item
                out.append(_inline(esc))
            else:
                para.append(esc)
        i += 1
    flush_para()
    close_lists()
    return "\n".join(out)


def build_docs(src_dirs=("docs",), extra_files=("README.md", "PARITY.md"),
               out_dir: str = "docs/_build",
               root: str = ".") -> List[Path]:
    """Render every Markdown page to ``out_dir`` with a shared nav + index.
    Returns the written paths."""
    root_p = Path(root)
    pages: List[Tuple[str, Path]] = []
    for d in src_dirs:
        for p in sorted((root_p / d).glob("*.md")):
            pages.append((p.stem, p))
    for f in extra_files:
        p = root_p / f
        if p.exists():
            pages.append((p.stem, p))
    if not pages:
        raise FileNotFoundError(f"no markdown pages under {src_dirs} "
                                f"or {extra_files} (root={root})")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    nav = '<a href="index.html">index</a>' + "".join(
        f'<a href="{name}.html">{name}</a>' for name, _ in pages)
    written: List[Path] = []
    index_items: List[str] = []
    for name, path in pages:
        md = path.read_text(encoding="utf-8")
        title = next((ln.lstrip("# ").strip() for ln in md.splitlines()
                      if ln.startswith("#")), name)
        dest = out / f"{name}.html"
        dest.write_text(_PAGE.format(title=html.escape(title), nav=nav,
                                     body=md_to_html(md)), encoding="utf-8")
        written.append(dest)
        index_items.append(f'<li><a href="{name}.html">'
                           f"{html.escape(title)}</a></li>")
    idx = out / "index.html"
    idx.write_text(_PAGE.format(
        title="deepcv_tpu docs", nav=nav,
        body="<h1>deepcv_tpu documentation</h1><ul>"
             + "".join(index_items) + "</ul>"), encoding="utf-8")
    written.append(idx)
    return written
