"""SurrealQL lexer (reference: core/src/syn/lexer/)."""

from __future__ import annotations

from decimal import Decimal

from surrealdb_tpu_torch.err import ParseError
from surrealdb_tpu_torch.val import Duration

# token kinds
IDENT = "IDENT"
PARAM = "PARAM"
INT = "INT"
FLOAT = "FLOAT"
DECIMAL = "DECIMAL"
DURATION = "DURATION"
STRING = "STRING"
DATETIME_STR = "DATETIME"
UUID_STR = "UUID"
RECORD_STR = "RECORD"
BYTES_LIT = "BYTES"
FILE_STR = "FILE"
REGEX = "REGEX"
OP = "OP"
EOF = "EOF"
SCRIPT = "SCRIPT"


def _scan_script(src, k, err):
    """Raw-scan `($args) { body }` starting at the '(' — JS-aware string/
    comment/brace matching. Returns the end index past the closing brace,
    or None when this isn't a script function."""
    n = len(src)
    depth = 0
    i = k
    # argument list (SurrealQL params — simple paren matching with strings)
    while i < n:
        c = src[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                i += 1
                break
        elif c in "'\"":
            q = c
            i += 1
            while i < n and src[i] != q:
                if src[i] == "\\":
                    i += 1
                i += 1
        i += 1
    while i < n and src[i] in " \t\r\n":
        i += 1
    if i >= n or src[i] != "{":
        return None
    depth = 0
    while i < n:
        c = src[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i + 1
        elif c in "'\"`":
            q = c
            i += 1
            while i < n:
                if src[i] == "\\":
                    i += 2
                    continue
                if src[i] == q:
                    break
                # template interpolation braces balance inside the outer
                # depth count, so no special handling needed beyond strings
                if q == "`" and src[i] == "$" and i + 1 < n and src[i + 1] == "{":
                    d2 = 0
                    while i < n:
                        if src[i] == "{":
                            d2 += 1
                        elif src[i] == "}":
                            d2 -= 1
                            if d2 == 0:
                                break
                        elif src[i] == "\\":
                            i += 1
                        i += 1
                i += 1
        elif c == "/" and i + 1 < n and src[i + 1] == "/":
            while i < n and src[i] != "\n":
                i += 1
        elif c == "/" and i + 1 < n and src[i + 1] == "*":
            i += 2
            while i + 1 < n and not (src[i] == "*" and src[i + 1] == "/"):
                i += 1
            i += 1
        i += 1
    err("unterminated script function body")

_PUNCT3 = ("..=", "...", "?:=")
_PUNCT2 = (
    "<|", "|>", "::", "->", "<~", "<-", "..", ">=", "<=", "==", "!=", "?=", "*=",
    "!~", "?~", "*~", "&&", "||", "??", "?:", "**", "+=", "-=", "+?=", "@@",
)
_PUNCT1 = "+-*/%<>=!?()[]{},;:.|&@~$×÷∋∌⊇⊆∈∉⟨`…"

_DUR_UNITS = ("ns", "us", "µs", "ms", "s", "m", "h", "d", "w", "y")

# tokens after which a `/` means division, not a regex start
_OPERAND_END = {IDENT, INT, FLOAT, DECIMAL, DURATION, STRING, DATETIME_STR,
                UUID_STR, RECORD_STR, BYTES_LIT, PARAM}


class Token:
    __slots__ = ("kind", "text", "value", "pos", "line", "col", "ws_before")

    def __init__(self, kind, text, value, pos, line, col, ws_before):
        self.kind = kind
        self.text = text
        self.value = value
        self.pos = pos
        self.line = line
        self.col = col
        self.ws_before = ws_before

    def __repr__(self):
        return f"Token({self.kind},{self.text!r})"


def _is_ident_start(c: str) -> bool:
    return c.isalpha() or c == "_"


def _is_ident(c: str) -> bool:
    return c.isalnum() or c == "_"


def _is_ascii_digit(c: str) -> bool:
    # unicode isdigit() accepts superscripts/fractions that int() rejects
    return "0" <= c <= "9"


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(src)
    line, col = 1, 1
    ws = False

    def err(msg):
        raise ParseError(msg, line, col)

    def push(kind, text, value, start):
        nonlocal ws
        toks.append(Token(kind, text, value, start, line, col, ws))
        ws = False

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n":
            if c == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1
            ws = True
            continue
        # comments
        if src.startswith("--", i) or src.startswith("//", i) or c == "#":
            while i < n and src[i] != "\n":
                i += 1
            ws = True
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                err("unterminated block comment")
            for ch in src[i : j + 2]:
                if ch == "\n":
                    line += 1
                    col = 1
                else:
                    col += 1
            i = j + 2
            ws = True
            continue
        start = i
        # params
        if c == "$" and i + 1 < n and (_is_ident_start(src[i + 1])):
            j = i + 1
            while j < n and _is_ident(src[j]):
                j += 1
            push(PARAM, src[start:j], src[start + 1 : j], start)
            col += j - i
            i = j
            continue
        # $`escaped param` / $⟨escaped param⟩
        if c == "$" and i + 1 < n and src[i + 1] in "`⟨":
            close = "`" if src[i + 1] == "`" else "⟩"
            name, j = _lex_quoted_ident(src, i + 1, close, err)
            push(PARAM, src[start:j], name, start)
            col += j - i
            i = j
            continue
        # backtick / angle-bracket quoted identifiers
        if c == "`":
            val, j = _lex_quoted_ident(src, i, "`", err)
            push(IDENT, src[start:j], val, start)
            col += j - i
            i = j
            continue
        if c == "⟨":
            val, j = _lex_quoted_ident(src, i, "⟩", err)
            push(IDENT, src[start:j], val, start)
            col += j - i
            i = j
            continue
        # prefixed strings: s' d' u' r' b" f"
        if c in "sdurbf" and i + 1 < n and src[i + 1] in "'\"":
            quote = src[i + 1]
            s, j = _lex_string(src, i + 1, quote, err)
            kindmap = {
                "s": STRING,
                "d": DATETIME_STR,
                "u": UUID_STR,
                "r": RECORD_STR,
                "b": BYTES_LIT,
                "f": FILE_STR,
            }
            kind = kindmap[c]
            val = s
            if kind == BYTES_LIT:
                try:
                    val = bytes.fromhex(s)
                except ValueError:
                    err(f"invalid bytes literal {s!r}")
            push(kind, src[start:j], val, start)
            col += j - i
            i = j
            continue
        # plain strings
        if c in "'\"":
            s, j = _lex_string(src, i, c, err)
            push(STRING, src[start:j], s, start)
            col += j - i
            i = j
            continue
        # numbers / durations
        if _is_ascii_digit(c):
            tok, j = _lex_number(src, i, err)
            toks.append(
                Token(tok[0], src[start:j], tok[1], start, line, col, ws)
            )
            ws = False
            col += j - i
            i = j
            continue
        # identifiers / keywords
        if _is_ident_start(c):
            j = i
            while j < n and _is_ident(src[j]):
                j += 1
            word = src[start:j]
            # `function (...) { raw js }` — embedded script: the body is a
            # different language, captured raw (reference fnc/script)
            if word == "function":
                k = j
                while k < n and src[k] in " \t\r\n":
                    k += 1
                if k < n and src[k] == "(":
                    endp = _scan_script(src, k, err)
                    if endp is not None:
                        push(SCRIPT, src[start:endp], src[start:endp], start)
                        col += endp - i
                        i = endp
                        continue
            push(IDENT, word, word, start)
            col += j - i
            i = j
            continue
        # regex literal (only where an operand is expected)
        if c == "/":
            prev = toks[-1] if toks else None
            operand_pos = prev is None or not (
                prev.kind in _OPERAND_END
                or (prev.kind == OP and prev.text in (")", "]", "}"))
            )
            if operand_pos:
                j = i + 1
                buf = []
                while j < n and src[j] != "/":
                    if src[j] == "\\" and j + 1 < n and src[j + 1] == "/":
                        buf.append("/")
                        j += 2
                    elif src[j] == "\\":
                        buf.append(src[j])
                        buf.append(src[j + 1])
                        j += 2
                    else:
                        buf.append(src[j])
                        j += 1
                if j >= n:
                    err("unterminated regex")
                push(REGEX, src[start : j + 1], "".join(buf), start)
                col += j + 1 - i
                i = j + 1
                continue
        # punctuation
        matched = None
        for p in _PUNCT3:
            if src.startswith(p, i):
                matched = p
                break
        if matched is None:
            for p in _PUNCT2:
                if src.startswith(p, i):
                    # `<-` could be `<->`
                    if p == "<-" and src.startswith("<->", i):
                        matched = "<->"
                    else:
                        matched = p
                    break
        if matched is None and c in _PUNCT1:
            matched = c
        if matched is None:
            err(f"unexpected character {c!r}")
        push(OP, matched, matched, start)
        col += len(matched)
        i += len(matched)
        continue

    toks.append(Token(EOF, "", None, n, line, col, ws))
    return toks


def _lex_quoted_ident(src, i, close, err):
    """Lex a `backtick` / ⟨angle⟩ identifier starting at src[i] (the
    opening delimiter); escape sequences match the reference ident lexer
    (\\0 \\t \\n \\f \\r \\b and literal escapes). Returns (name, end)."""
    j = i + 1
    n = len(src)
    buf = []
    esc = {"0": "\0", "t": "\t", "n": "\n", "f": "\f", "r": "\r",
           "b": "\b"}
    hexd = "0123456789abcdefABCDEF"
    while j < n and src[j] != close:
        if src[j] == "\\" and j + 1 < n:
            e = src[j + 1]
            if e == "u":
                # \u{X..X} or \uXXXX, as in strings
                if j + 2 < n and src[j + 2] == "{":
                    k = src.find("}", j + 3)
                    if k < 0 or not all(c in hexd for c in src[j + 3 : k]) \
                            or not src[j + 3 : k]:
                        err("Invalid escape sequence in identifier")
                    buf.append(chr(int(src[j + 3 : k], 16)))
                    j = k + 1
                    continue
                hexs = src[j + 2 : j + 6]
                if len(hexs) < 4 or any(c not in hexd for c in hexs):
                    err("Invalid escape sequence in identifier")
                buf.append(chr(int(hexs, 16)))
                j += 6
                continue
            buf.append(esc.get(e, e))
            j += 2
        else:
            buf.append(src[j])
            j += 1
    if j >= n:
        err(f"unterminated {close} identifier")
    return "".join(buf), j + 1


def _lex_string(src, i, quote, err):
    """Lex a quoted string starting at src[i]==quote; return (value, end)."""
    j = i + 1
    n = len(src)
    buf = []
    while j < n:
        ch = src[j]
        if ch == "\\" and j + 1 < n:
            e = src[j + 1]
            if e == "n":
                buf.append("\n")
            elif e == "t":
                buf.append("\t")
            elif e == "r":
                buf.append("\r")
            elif e == "b":
                buf.append("\b")
            elif e == "f":
                buf.append("\f")
            elif e == "0":
                buf.append("\0")
            elif e == "u":
                # \u{X..XXXXXX} (1-6 hex) or \uXXXX (exactly 4 hex,
                # surrogate pairs combined) — invalid digits, overlong
                # braces, and lone surrogates are parse errors like the
                # reference lexer
                hexd = "0123456789abcdefABCDEF"
                if j + 2 < n and src[j + 2] == "{":
                    k = j + 3
                    while k < n and src[k] != "}":
                        if src[k] not in hexd:
                            err(
                                "Invalid escape sequence, expected `}` or "
                                "hexadecimal character"
                            )
                        if k - (j + 3) >= 6:
                            err(
                                "Invalid escape sequence, expected `}` "
                                "character. Too many hex-digits"
                            )
                        k += 1
                    if k >= n or k == j + 3:
                        err("Invalid escape sequence, expected "
                            "hexadecimal character")
                    cp = int(src[j + 3 : k], 16)
                    if cp > 0x10FFFF or 0xD800 <= cp <= 0xDFFF:
                        err("Invalid escape sequence, not a valid "
                            "unicode codepoint")
                    buf.append(chr(cp))
                    j = k + 1
                    continue
                hexs = src[j + 2 : j + 6]
                if len(hexs) < 4 or any(c not in hexd for c in hexs):
                    err(
                        "String contains invalid escape sequence, "
                        "expected a hexadecimal character"
                    )
                cp = int(hexs, 16)
                j += 6
                if 0xD800 <= cp <= 0xDBFF:
                    # high surrogate: a \uDC00-\uDFFF low half must follow
                    lo = None
                    if src[j : j + 2] == "\\u":
                        lhex = src[j + 2 : j + 6]
                        if len(lhex) == 4 and all(c in hexd for c in lhex):
                            lv = int(lhex, 16)
                            if 0xDC00 <= lv <= 0xDFFF:
                                lo = lv
                    if lo is None:
                        err("String contains invalid escape sequence, "
                            "missing trailing surrogate")
                    cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00)
                    j += 6
                elif 0xDC00 <= cp <= 0xDFFF:
                    err("String contains invalid escape sequence, "
                        "unexpected trailing surrogate")
                buf.append(chr(cp))
                continue
            elif e in ("\\", "/", "'", '"', "`"):
                buf.append(e)
            else:
                err("Invalid escape sequence")
            j += 2
            continue
        if ch == quote:
            return "".join(buf), j + 1
        buf.append(ch)
        j += 1
    err("unterminated string")


def _lex_number(src, i, err):
    n = len(src)
    j = i
    while j < n and (_is_ascii_digit(src[j]) or src[j] == "_"):
        j += 1
    is_float = False

    def _unit_ok(k, u):
        """Unit match at k is terminal: next char must not extend an ident
        (digits are fine — they start the next duration segment)."""
        e = k + len(u)
        return not (e < n and (src[e].isalpha() or src[e] == "_"))

    # duration? digits followed by a unit
    for u in ("ns", "us", "µs", "ms", "y", "w", "d", "h", "m", "s"):
        if src.startswith(u, j) and _unit_ok(j, u):
            # consume chained segments: 1h30m20s
            total = int(src[i:j].replace("_", "")) * Duration.UNITS[u]
            j += len(u)
            while j < n and _is_ascii_digit(src[j]):
                k = j
                while k < n and _is_ascii_digit(src[k]):
                    k += 1
                got = False
                for u2 in ("ns", "us", "µs", "ms", "y", "w", "d", "h", "m", "s"):
                    if src.startswith(u2, k) and _unit_ok(k, u2):
                        total += int(src[j:k]) * Duration.UNITS[u2]
                        j = k + len(u2)
                        got = True
                        break
                if not got:
                    break
            if total > Duration.MAX_NS:
                err("duration exceeds maximum")
            return (DURATION, Duration(total)), j
    if j < n and src[j] == "." and j + 1 < n and _is_ascii_digit(src[j + 1]):
        is_float = True
        j += 1
        while j < n and (_is_ascii_digit(src[j]) or src[j] == "_"):
            j += 1
    if j < n and src[j] in "eE" and (
        (j + 1 < n and _is_ascii_digit(src[j + 1]))
        or (j + 2 < n and src[j + 1] in "+-" and _is_ascii_digit(src[j + 2]))
    ):
        is_float = True
        j += 1
        if src[j] in "+-":
            j += 1
        while j < n and _is_ascii_digit(src[j]):
            j += 1
    text = src[i:j].replace("_", "")
    if src.startswith("dec", j) and not (j + 3 < n and _is_ident(src[j + 3])):
        return (DECIMAL, Decimal(text)), j + 3
    if j < n and src[j] == "f" and not (j + 1 < n and _is_ident(src[j + 1])):
        return (FLOAT, float(text)), j + 1
    if is_float:
        return (FLOAT, float(text)), j
    return (INT, int(text)), j
