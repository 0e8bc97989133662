"""Build the rendered documentation site (docs/site/*.html).

The reference ships a rendered sphinx tree with a benchmarks page
(``/root/reference/sphinx-docs/source/``, ``benchmarks.html``); this
repo's docs are markdown-first, and this generator renders them to a
static HTML site with the stdlib-adjacent ``markdown`` + ``pygments``
packages (no sphinx in the image, and installs are off-limits).

Pages: every guide in ``docs/`` and the repo-level README / PERF /
CHANGES / ROADMAP / PARITY. Measurements live in PERF.md, each with the
card it was taken on.

Run:  python docs/build_site.py        (writes docs/site/, not committed)
CI runs it on every push (docs job) and uploads the site artifact.
"""

import html
import os
import re

import markdown

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
OUT = os.path.join(DOCS, "site")

# (source path relative to ROOT, output name, nav title)
PAGES = [
    ("docs/index.md", "index.html", "Overview"),
    ("README.md", "readme.html", "README"),
    ("docs/building_a_model.md", "building_a_model.html",
     "Building a model"),
    ("docs/running.md", "running.html", "Running simulations"),
    ("docs/coarse_graining.md", "coarse_graining.html",
     "Coarse-graining"),
    ("docs/migrating_from_hoomd_tf.md", "migrating.html",
     "Migrating from hoomd-tf"),
    ("PERF.md", "performance.html", "Performance (measured)"),
    ("docs/testing.md", "testing.html", "Testing"),
    ("PARITY.md", "parity.html", "Reference parity map"),
    ("CHANGES.md", "changes.html", "Changes"),
    ("ROADMAP.md", "roadmap.html", "Roadmap"),
]

TEMPLATE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — hoomd_tf_tpu</title>
<style>
:root {{ --fg:#1a1d21; --bg:#ffffff; --muted:#5c6570; --line:#e3e6ea;
        --accent:#0b57d0; --code-bg:#f6f8fa; }}
* {{ box-sizing:border-box; }}
body {{ margin:0; font:16px/1.6 system-ui,-apple-system,"Segoe UI",
       sans-serif; color:var(--fg); background:var(--bg); }}
.wrap {{ display:flex; min-height:100vh; }}
nav {{ width:240px; flex:none; border-right:1px solid var(--line);
      padding:24px 16px; position:sticky; top:0; height:100vh;
      overflow-y:auto; }}
nav h1 {{ font-size:17px; margin:0 0 4px; }}
nav .sub {{ color:var(--muted); font-size:12.5px; margin-bottom:16px; }}
nav a {{ display:block; padding:5px 8px; border-radius:6px;
        color:var(--fg); text-decoration:none; font-size:14px; }}
nav a:hover {{ background:var(--code-bg); }}
nav a.here {{ color:var(--accent); font-weight:600;
             background:var(--code-bg); }}
main {{ flex:1; min-width:0; max-width:860px; padding:32px 40px 80px; }}
main h1,main h2,main h3 {{ line-height:1.25; }}
main h1 {{ font-size:28px; }}
main h2 {{ margin-top:2em; border-bottom:1px solid var(--line);
          padding-bottom:4px; }}
a {{ color:var(--accent); }}
pre {{ background:var(--code-bg); border:1px solid var(--line);
      border-radius:8px; padding:12px 14px; overflow-x:auto;
      font-size:13.5px; line-height:1.5; }}
code {{ font-family:ui-monospace,SFMono-Regular,Menlo,monospace;
       font-size:0.92em; background:var(--code-bg);
       padding:1px 4px; border-radius:4px; }}
pre code {{ background:none; padding:0; }}
table {{ border-collapse:collapse; margin:1em 0; font-size:14.5px;
        display:block; overflow-x:auto; }}
th,td {{ border:1px solid var(--line); padding:6px 10px;
        text-align:left; vertical-align:top; }}
th {{ background:var(--code-bg); }}
blockquote {{ margin:1em 0; padding:2px 16px; color:var(--muted);
             border-left:3px solid var(--line); }}
.note {{ color:var(--muted); font-size:13px; }}
{pygments}
</style></head><body><div class="wrap">
<nav><h1>hoomd_tf_tpu</h1>
<div class="sub">ML molecular dynamics in JAX</div>
{nav}</nav>
<main>{body}</main>
</div></body></html>
"""


def pygments_css():
    try:
        from pygments.formatters import HtmlFormatter
        return HtmlFormatter(style="default").get_style_defs(
            ".codehilite")
    except Exception:
        return ""


def nav_html(current):
    out = []
    for _, name, title in PAGES:
        cls = ' class="here"' if name == current else ""
        out.append(f'<a href="{name}"{cls}>{html.escape(title)}</a>')
    return "\n".join(out)


_LINK_MAP = {os.path.basename(src): out
             for src, out, _ in PAGES if src}
_LINK_MAP.update({"README.md": "readme.html"})


def rewrite_links(body_html):
    """Point intra-doc .md links at their rendered pages."""
    def sub(m):
        target = m.group(1).split("/")[-1]
        return 'href="%s"' % _LINK_MAP.get(target, m.group(0)[6:-1])
    return re.sub(r'href="([^"#]+\.md)"', sub, body_html)


def render_markdown(text):
    md = markdown.Markdown(extensions=[
        "extra", "toc", "sane_lists", "codehilite"],
        extension_configs={"codehilite": {"guess_lang": False}})
    return md.convert(text)


def main():
    os.makedirs(OUT, exist_ok=True)
    css = pygments_css()
    for src, name, title in PAGES:
        with open(os.path.join(ROOT, src)) as f:
            body = rewrite_links(render_markdown(f.read()))
        page = TEMPLATE.format(title=html.escape(title),
                               nav=nav_html(name), body=body,
                               pygments=css)
        with open(os.path.join(OUT, name), "w") as f:
            f.write(page)
        print("wrote", os.path.join("docs/site", name))


if __name__ == "__main__":
    main()
