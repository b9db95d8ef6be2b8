"""HTML documents built from a list of texts (the corpus's chunks), for
chip_smoke.py's document indexing and service phases and their committed
oracle (``tests/data/html/oracle.json``, written by
``python -m tests.utils.make_image_fixtures``): an article with headings,
paragraphs and inline markup, lists, tables (with and without <tbody>, a
caption), text divs (direct text, nested containers), one malformed page
(unclosed <p>, <li> and <td>, blocks in <p>, stray end tags, text between
</head> and <body>, entities, comments, script and style), and a page in
a declared single-byte charset. Standard library only (chip_smoke loads
it from its file)."""

import html
import re


def _sentences(text: str) -> list[str]:
    parts = [s.strip() for s in re.split(r"(?<=[.!?])\s+|\n+", text) if s.strip()]
    return parts or [text.strip() or "empty"]


def _inline(text: str, k: int) -> str:
    """``text`` escaped, with a word in <b>, <i> or <a> every few words."""
    words = html.escape(text, quote=False).split(" ")
    tags = ("b", "i", "a href='#n'", "em", "code")
    for i in range(1 + k % 3, len(words), 5):
        tag = tags[(i + k) % len(tags)]
        words[i] = f"<{tag}>{words[i]}</{tag.split()[0]}>"
    return " ".join(words)


def _title(text: str) -> str:
    return html.escape(" ".join(text.split()[:4]).title().rstrip(".,;:"), quote=False)


def build_html_documents(texts: list[str]) -> list[tuple[str, bytes]]:
    """(name, bytes) of the HTML documents, each from a slice of ``texts``."""
    t = [x for x in texts if x.strip()]
    take = iter(range(10**6))

    def nxt() -> str:
        return t[next(take) % len(t)]

    docs = []
    # an article: h1, sections under h2 / h3, paragraphs with inline markup
    body = [f"<h1>{_title(nxt())}</h1>"]
    for k in range(4):
        body.append(f"<h{2 + k % 2}>{_title(nxt())}</h{2 + k % 2}>")
        for s in _sentences(nxt())[:4]:
            body.append(f"<p>{_inline(s, k)}</p>")
    docs.append(("article.html", ("<!DOCTYPE html>\n<html lang='en'>\n<head>\n<meta charset='utf-8'>\n"
                                  f"<title>{_title(t[0])}</title>\n<style>p {{ margin: 0 }}</style>\n</head>\n"
                                  "<body>\n" + "\n".join(body) + "\n</body>\n</html>\n").encode()))
    # lists: unordered, ordered with nested items, a definition list
    items = _sentences(nxt()) + _sentences(nxt())
    lists = ["<h2>Points</h2>", "<ul>" + "".join(f"<li>{_inline(s, i)}</li>" for i, s in enumerate(items[:5])) + "</ul>",
             "<ol>" + "".join(f"<li>{html.escape(s)}<ul><li>{_title(s)}</li></ul></li>" for s in items[5:8]) + "</ol>",
             "<dl>" + "".join(f"<dt>{_title(s)}</dt><dd>{html.escape(s)}</dd>" for s in items[8:11]) + "</dl>"]
    docs.append(("lists.html", ("<html><body>" + "\n".join(lists) + "</body></html>").encode()))
    # tables: one with <thead> / <tbody> and a caption, one with bare rows
    words = nxt().split()
    rows = [words[i:i + 3] for i in range(0, min(len(words), 36), 3)]
    head = "<thead><tr><th>Term</th><th>Next</th><th>Then</th></tr></thead>"
    table1 = ("<table><caption>" + _title(nxt()) + "</caption>" + head + "<tbody>"
              + "".join("<tr>" + "".join(f"<td>{html.escape(w)}</td>" for w in r) + "</tr>" for r in rows[:6])
              + "</tbody></table>")
    table2 = ("<table>" + "".join("<tr>" + "".join(f"<td><b>{html.escape(w)}</b></td>" for w in r) + "</tr>"
                                  for r in rows[6:]) + "</table>")
    docs.append(("tables.html", (f"<html><body><p>{html.escape(nxt()[:200])}</p>{table1}"
                                 f"<p>Between the tables.</p>{table2}</body></html>").encode()))
    # text divs: hatnote-like divs with direct text, containers, a div with block children
    divs = [f"<div class='hatnote'>Main article: {_title(nxt())}</div>",
            f"<div><div><div>{html.escape(nxt()[:300])}</div></div></div>",
            f"<div>Lead text <span>{html.escape(nxt()[:120])}</span><p>{html.escape(nxt()[:200])}</p></div>",
            f"<div><!--note--><span>{html.escape(nxt()[:150])}</span></div>"]
    docs.append(("divs.html", ("<html><body>" + "".join(divs) + "</body></html>").encode()))
    # a malformed page
    a, b, c, d = (html.escape(nxt()[:240], quote=False) for _ in range(4))
    bad = (f"<html><head><title>{_title(a)}</title><script>if (a < b) {{ x = '<p>'; }}</script></head>"
           f"Loose text between head and body. <body>"
           f"<p>{a}<div>{b}</div>{c}</p></span></b>"
           f"<ul><li>{_sentences(d)[0]}<li>second item &amp; more&nbsp;text<li>third &bogus; item</ul>"
           f"<table><tr><td>cell one<td>cell two<tr><td>cell three &copy 2024</table>"
           f"<p>Unclosed paragraph<!-- a comment --> with &#8212; dash<p>Another &lt;tag&gt; text"
           f"<h2>Heading <i>in</i> italics</h2>Trailing text</div></body></html>tail")
    docs.append(("malformed.html", bad.encode()))
    # a page in a declared single-byte charset
    e = _sentences(nxt())[:3]
    latin = ("<html><head><meta http-equiv='Content-Type' content='text/html; charset=iso-8859-1'></head><body>"
             "<h1>Café naïve über</h1>" + "".join(f"<p>{html.escape(s)} éè</p>" for s in e)
             + "</body></html>")
    docs.append(("latin1.html", latin.encode("iso-8859-1", "replace")))
    return docs
