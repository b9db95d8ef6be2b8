"""Seeded malformed HTML pages for the HTML parity tests: unclosed and
stray tags, blocks nested in <p>, tables with and without <tbody>, lists,
entities (named, numeric, legacy without ";", unknown), comments (and
the forms HTML reads as comments), <br> and other void elements,
script / style / template / raw-text elements, misplaced html / head /
body tags, text around them, tags cut off by the end, and the bytes in
UTF-8, UTF-8 or UTF-16 with a byte-order mark, a declared charset, or
undeclared Latin-1. Standard library only."""

import random

WORDS = ["alps", "glacier", "Mont Blanc", "Rhône", "café", "naïve", "über", "ß", "Zürich", "peak", "valley",
         "4,808 m", "snow", "—", "“quoted”", "a+b", "x<y", "1 & 2", "€5", "日本", "Ελλάδα", "tunnel", "pass"]
ENTITIES = ["&nbsp;", "&amp;", "&lt;", "&gt;", "&copy", "&bogus;", "&#8212;", "&#x41;", "&#128;", "&quot;",
            "&eacute;", "&amp", "&notin;", "&noti", "&#0;", "&#xD800;", "&#1;", "&#x9F;"]
INLINE = ["span", "b", "i", "a", "em", "strong", "code", "small", "u", "font", "sup", "abbr", "mark", "q"]
BLOCK = ["p", "div", "h1", "h2", "h3", "h4", "h5", "h6", "pre", "blockquote", "section", "article",
         "figure", "figcaption", "center", "address", "form", "fieldset", "main", "nav", "header", "footer"]
LISTS = ["ul", "ol", "li", "dl", "dt", "dd", "menu"]
TABLE = ["table", "tbody", "thead", "tfoot", "tr", "td", "th", "caption", "colgroup", "col"]
OTHER = ["select", "option", "optgroup", "button", "label", "object", "map", "details", "summary", "nobr",
         "my-el", "DIV", "P", "Td", "ruby", "rt", "rp"]
VOID = ["br", "hr", "img", "input", "meta", "link", "wbr", "area", "base", "param", "frame"]
RAW = ["script", "style", "noscript", "template", "title", "textarea", "xmp", "iframe", "noembed", "noframes"]
ODD = ["<!-- note -->", "<!---->", "<!-->", "<!-- a -- b -->", "<?php x ?>", "<![CDATA[c]]>", "<!x>", "</ p>",
       "</>", "<!--x--!>", "<", "a < b", "&", "&#", "<p class='a>b'>", '<p title="x>y">', "<p\n>", "</p\n>",
       "</p foo=bar>", "<html lang=en>", "<head>", "<body class=b>", "</html>", "</body>", "</head>",
       "<!DOCTYPE html>"]


def text(rng: random.Random) -> str:
    parts = []
    for _ in range(rng.randint(1, 4)):
        r = rng.random()
        if r < 0.6:
            parts.append(rng.choice(WORDS))
        elif r < 0.8:
            parts.append(rng.choice(ENTITIES))
        else:
            parts.append(rng.choice([" ", "\n", "  \t", "\r\n", " \n "]))
    return rng.choice(["", " ", "\n"]).join(parts)


def fragment(rng: random.Random, depth: int) -> str:
    out = []
    for _ in range(rng.randint(1, 5)):
        r = rng.random()
        if r < 0.25 or depth > 4:
            out.append(text(rng))
        elif r < 0.32:
            out.append(rng.choice(ODD))
        elif r < 0.39:
            out.append("<" + rng.choice(VOID) + rng.choice(["", "/", " /"]) + ">")
        elif r < 0.46:
            out.append("</" + rng.choice(INLINE + BLOCK + LISTS + TABLE + OTHER + ["html", "body", "head", "br"]) + ">")
        elif r < 0.51:
            tag = rng.choice(RAW)
            inner = rng.choice(["var a = '<p>x</p>';", "p { color: red }", "<b>x</b> &amp; y", "plain &#1; text"])
            out.append(f"<{tag}>{inner}" + (f"</{tag}>" if rng.random() < 0.9 else ""))
        else:
            tag = rng.choice(rng.choice([INLINE, BLOCK, LISTS, TABLE, OTHER, BLOCK]))
            attrs = rng.choice(["", " class=x", ' id="a&amp;b"', " title='t'"])
            inner = fragment(rng, depth + 1)
            close = rng.random()
            end = f"</{tag}>" if close < 0.7 else (f"</{rng.choice(INLINE + BLOCK)}>" if close < 0.8 else "")
            out.append(f"<{tag}{attrs}>{inner}{end}")
    return "".join(out)


def page(seed: int) -> bytes:
    """One malformed page, a function of ``seed``."""
    rng = random.Random(seed)
    head = ""
    if rng.random() < 0.7:
        head = "".join(rng.choice(["<title>T &amp; t</title>", "<meta name=x content=y>", "<style>b{}</style>",
                                   "<script>if (a < b) {}</script>", "<link rel=x>", " stray ", "\n"])
                       for _ in range(rng.randint(1, 4)))
    body = fragment(rng, 0)
    shape = rng.random()
    if shape < 0.3:
        doc = f"<html><head>{head}</head><body>{body}</body></html>"
    elif shape < 0.5:
        doc = f"<!DOCTYPE html>\n<html>\n<head>{head}</head>\n{rng.choice(['', 'between'])}<body>{body}"
    elif shape < 0.7:
        doc = head + body
    elif shape < 0.8:
        doc = f"<body>{body}</body>{rng.choice(['', 'after', '<p>late</p>'])}</html>{rng.choice(['', ' tail'])}"
    else:
        doc = body
    if rng.random() < 0.1:
        doc += rng.choice(["<!-- open", "<p", "</p", "<!x", "&amp", "<?x", "<div class='a"])
    enc = rng.random()
    if enc < 0.08:
        return b"\xef\xbb\xbf" + doc.encode("utf-8")
    if enc < 0.12:
        return b"\xff\xfe" + doc.encode("utf-16-le")
    if enc < 0.2:
        charset = rng.choice(["iso-8859-1", "windows-1252", "iso-8859-2", "utf-8"])
        decl = rng.choice([f'<meta charset="{charset}">', f"<meta charset={charset}>",
                           f'<meta http-equiv="Content-Type" content="text/html; charset={charset}">'])
        return (decl + doc).encode(charset, "replace")
    if enc < 0.25:
        return doc.encode("latin-1", "replace")  # undeclared bytes that are not UTF-8
    return doc.encode("utf-8")
