"""Headless DOM/browser host for executing page glue under minijs.

The port's copy of ``routest_tpu/utils/jsdom.py``. ``utils/minijs.py``
executes the dashboard's pure-logic modules; this module supplies the
browser half so the PAGE GLUE runs too — ``boot()``, the calculate
click, the SSE tracker, CSV export — against a real server, with no
node/browser on the machine. The reference gets this assurance
manually, by people loading the Next.js app
(``frontend/map-app/app/ui/page.jsx``); here it is a deterministic
harness.

The server is reached through any client with the werkzeug test
client's shape: ``open(url, method=, headers=, data=)`` and
``get(url)``, returning an object with ``status_code``,
``get_data(as_text=False)`` and ``headers.get``. The module imports no
werkzeug (the card's host has none): the CPU tests hand it a werkzeug
``Client``, ``chip_smoke.py`` a small ``urllib`` adapter over a live
socket.

Scope — exactly what the shipped pages touch (inventoried from
``serve/static/dashboard.html`` / ``mvp.html``):

- a DOM built by PARSING THE REAL PAGE HTML (``html.parser``), so
  ``getElementById`` resolves the page's actual ids;
- elements: textContent/innerHTML (fragment-parsed), className,
  classList, style, value/checked/disabled, appendChild, setAttribute,
  querySelector(All) for the ``tag``/``#id``/``.class``/``:checked``
  selector subset, parentElement, event-handler properties, click();
- ``document.createElement(NS)/createTextNode``, ``querySelectorAll``;
- ``fetch`` bridged SYNCHRONOUSLY to that client (returns a settled
  promise — minijs has no event loop);
- ``EventSource`` (instances recorded; tests fire ``onmessage``),
  ``localStorage``, ``setTimeout/setInterval`` (recorded, fired by the
  test), ``Blob``/``URL.createObjectURL`` + anchor ``click()``
  (downloads recorded), ``Date`` (ISO parsing + display methods),
  ``Option``.

Everything is synchronous and deterministic: timers never auto-fire,
promises settle eagerly, and all side effects (downloads, event
sources, timers) are recorded on the :class:`DomHost` for assertions.
"""

from __future__ import annotations

import datetime as _dt
import json as _json
import re as _re
from html.parser import HTMLParser
from typing import Any, Dict, List, Optional

from routest_tpu_torch.utils.minijs import (
    UNDEFINED,
    Interpreter,
    JSPromise,
)

__all__ = ["DomHost", "Element", "Event"]


# ---------------------------------------------------------------------------
# DOM nodes
# ---------------------------------------------------------------------------

_VOID_TAGS = {"input", "br", "img", "hr", "meta", "link"}


class _ClassList:
    def __init__(self, el: "Element"):
        self._el = el

    def _classes(self) -> List[str]:
        return [c for c in self._el.props.get("className", "").split()
                if c]

    def _store(self, classes: List[str]):
        self._el.props["className"] = " ".join(classes)

    def js_get_member(self, name: str):
        if name == "add":
            def add(*cs):
                classes = self._classes()
                for c in cs:
                    if c not in classes:
                        classes.append(str(c))
                self._store(classes)
            return add
        if name == "remove":
            def remove(*cs):
                self._store([c for c in self._classes() if c not in cs])
            return remove
        if name == "toggle":
            def toggle(c):
                classes = self._classes()
                if c in classes:
                    classes.remove(c)
                    self._store(classes)
                    return False
                classes.append(str(c))
                self._store(classes)
                return True
            return toggle
        if name == "contains":
            return lambda c: c in self._classes()
        return UNDEFINED

    def js_set_member(self, name: str, value):
        raise AttributeError(f"classList.{name} is read-only")


class _Style:
    def __init__(self):
        self.props: Dict[str, Any] = {}

    def js_get_member(self, name: str):
        return self.props.get(name, "")

    def js_set_member(self, name: str, value):
        self.props[name] = value


class Event:
    """Minimal DOM event: tests pass one into recorded handlers."""

    def __init__(self, data: Any = UNDEFINED):
        self.data = data
        self.propagation_stopped = False

    def js_get_member(self, name: str):
        if name == "data":
            return self.data
        if name == "stopPropagation":
            def stop():
                self.propagation_stopped = True
            return stop
        if name == "preventDefault":
            return lambda: None
        return UNDEFINED

    def js_set_member(self, name: str, value):
        setattr(self, name, value)


class Element:
    def __init__(self, tag: str, host: "DomHost",
                 attrs: Optional[Dict[str, str]] = None):
        self.tag = tag.lower()
        self.host = host
        self.attrs: Dict[str, str] = dict(attrs or {})
        self.children: List[Any] = []   # Element | str (text)
        self.parent: Optional[Element] = None
        self.props: Dict[str, Any] = {}
        self.style = _Style()
        if "class" in self.attrs:
            self.props["className"] = self.attrs["class"]
        if "value" in self.attrs:
            self.props["value"] = self.attrs["value"]
        if "checked" in self.attrs:
            self.props["checked"] = True
        if "selected" in self.attrs:
            self.props["selected"] = True

    # -- tree ------------------------------------------------------------
    def append(self, child):
        if isinstance(child, Element):
            child.parent = self
        self.children.append(child)
        return child

    def walk(self):
        for c in self.children:
            if isinstance(c, Element):
                yield c
                yield from c.walk()

    # -- text ------------------------------------------------------------
    def _text(self) -> str:
        out = []
        for c in self.children:
            out.append(c._text() if isinstance(c, Element) else str(c))
        return "".join(out)

    # -- selectors -------------------------------------------------------
    def matches(self, part: str) -> bool:
        m = _re.fullmatch(
            r"(?P<tag>[a-zA-Z][\w-]*)?(?:#(?P<id>[\w-]+))?"
            r"(?P<classes>(?:\.[\w-]+)*)(?P<checked>:checked)?", part)
        if not m:
            return False
        if m.group("tag") and self.tag != m.group("tag").lower():
            return False
        if m.group("id") and self.attrs.get("id") != m.group("id"):
            return False
        classes = [c for c in (m.group("classes") or "").split(".") if c]
        have = set(self.props.get("className", "").split())
        if any(c not in have for c in classes):
            return False
        if m.group("checked") and not self.props.get("checked"):
            return False
        return True

    def select(self, selector: str) -> List["Element"]:
        parts = selector.strip().split()
        matched: List[Element] = [self]
        for part in parts:
            nxt: List[Element] = []
            for scope in matched:
                for el in scope.walk():
                    if el.matches(part) and el not in nxt:
                        nxt.append(el)
            matched = nxt
        return matched

    # -- minijs host protocol --------------------------------------------
    def js_get_member(self, name: str):
        if name == "textContent":
            return self._text()
        if name == "innerHTML":
            return _serialize_children(self)
        if name in ("className", "value", "checked", "disabled",
                    "selected", "href", "download", "title", "id"):
            if name == "id":
                return self.attrs.get("id", "")
            default = False if name in ("checked", "disabled",
                                        "selected") else ""
            if name == "value" and self.tag == "select":
                return self._select_value()
            return self.props.get(name, default)
        if name == "style":
            return self.style
        if name == "classList":
            return _ClassList(self)
        if name == "parentElement":
            return self.parent
        if name == "children":
            return [c for c in self.children if isinstance(c, Element)]
        if name == "appendChild":
            return self.append
        if name == "setAttribute":
            def set_attr(k, v):
                k, v = _to_text(k), _to_text(v)
                self.attrs[k] = v
                if k == "class":
                    self.props["className"] = v
            return set_attr
        if name == "getAttribute":
            return lambda k: self.attrs.get(str(k), None)
        if name == "querySelector":
            def qs(sel):
                got = self.select(str(sel))
                return got[0] if got else None
            return qs
        if name == "querySelectorAll":
            return lambda sel: self.select(str(sel))
        if name == "add" and self.tag == "select":
            return self.append          # select.add(new Option(...))
        if name == "click":
            return lambda: self.host._click(self)
        if name.startswith("on"):
            return self.props.get(name, UNDEFINED)
        return UNDEFINED

    def js_set_member(self, name: str, value):
        if name == "textContent":
            self.children = [] if value in (None, UNDEFINED) \
                else [_to_text(value)]
            return
        if name == "innerHTML":
            self.children = []
            _parse_fragment(_to_text(value), self, self.host)
            return
        if name == "className":
            self.props["className"] = _to_text(value)
            return
        self.props[name] = value

    def _select_value(self) -> str:
        opts = [c for c in self.walk() if c.tag == "option"]
        if "value" in self.props:        # explicitly set by script
            return self.props["value"]
        for o in opts:
            if o.props.get("selected"):
                return o.props.get("value", o._text())
        return opts[0].props.get("value", opts[0]._text()) if opts \
            else ""

    def __repr__(self):
        return f"<Element {self.tag} id={self.attrs.get('id')!r}>"


def _to_text(v) -> str:
    from routest_tpu_torch.utils.minijs import _js_str

    return _js_str(v)


def _serialize_children(el: Element) -> str:
    out = []
    for c in el.children:
        if isinstance(c, Element):
            attrs = "".join(f' {k}="{v}"' for k, v in c.attrs.items())
            if c.tag in _VOID_TAGS:
                out.append(f"<{c.tag}{attrs}>")
            else:
                out.append(f"<{c.tag}{attrs}>"
                           f"{_serialize_children(c)}</{c.tag}>")
        else:
            out.append(str(c))
    return "".join(out)


class _FragmentParser(HTMLParser):
    def __init__(self, root: Element, host: "DomHost"):
        super().__init__(convert_charrefs=True)
        self.stack = [root]
        self.host = host

    def handle_starttag(self, tag, attrs):
        el = Element(tag, self.host, dict(attrs))
        self.stack[-1].append(el)
        if tag.lower() not in _VOID_TAGS:
            self.stack.append(el)

    def handle_startendtag(self, tag, attrs):
        self.stack[-1].append(Element(tag, self.host, dict(attrs)))

    def handle_endtag(self, tag):
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].tag == tag.lower():
                del self.stack[i:]
                return

    def handle_data(self, data):
        if data:
            self.stack[-1].append(data)


def _parse_fragment(html: str, into: Element, host: "DomHost"):
    p = _FragmentParser(into, host)
    p.feed(html)
    p.close()


# ---------------------------------------------------------------------------
# Browser host objects
# ---------------------------------------------------------------------------

class _Document:
    def __init__(self, host: "DomHost"):
        self.host = host

    def js_get_member(self, name: str):
        host = self.host
        if name == "getElementById":
            def by_id(i):
                for el in host.root.walk():
                    if el.attrs.get("id") == str(i):
                        return el
                return None
            return by_id
        if name == "querySelectorAll":
            return lambda sel: host.root.select(str(sel))
        if name == "querySelector":
            def qs(sel):
                got = host.root.select(str(sel))
                return got[0] if got else None
            return qs
        if name in ("createElement", "createTextNode"):
            if name == "createTextNode":
                return lambda text="": _to_text(text)
            return lambda tag: Element(str(tag), host)
        if name == "createElementNS":
            return lambda ns, tag: Element(str(tag), host)
        if name == "body":
            return host.root
        return UNDEFINED

    def js_set_member(self, name, value):
        raise AttributeError(f"document.{name} is read-only")


class _LocalStorage:
    def __init__(self):
        self.data: Dict[str, str] = {}

    def js_get_member(self, name: str):
        if name == "getItem":
            return lambda k: self.data.get(_to_text(k), None)
        if name == "setItem":
            def set_item(k, v):
                self.data[_to_text(k)] = _to_text(v)
            return set_item
        if name == "removeItem":
            return lambda k: self.data.pop(_to_text(k), None)
        if name == "clear":
            return lambda: self.data.clear()
        return UNDEFINED

    def js_set_member(self, name, value):
        self.data[name] = _to_text(value)


class _Response:
    def __init__(self, status: int, body: bytes,
                 content_type: str = "application/json"):
        self.status_code = status
        self.body = body
        self.content_type = content_type

    def js_get_member(self, name: str):
        if name == "ok":
            return 200 <= self.status_code < 300
        if name == "status":
            return float(self.status_code)
        if name == "json":
            def json_():
                try:
                    return JSPromise.fulfilled(
                        Interpreter.to_js(_json.loads(self.body)))
                except Exception:
                    return JSPromise.rejected(
                        {"name": "SyntaxError",
                         "message": "invalid JSON body"})
            return json_
        if name == "text":
            return lambda: JSPromise.fulfilled(
                self.body.decode("utf-8", "replace"))
        return UNDEFINED

    def js_set_member(self, name, value):
        raise AttributeError("responses are read-only")


class _EventSource:
    def __init__(self, host: "DomHost", url: str):
        self.host = host
        self.url = url
        self.closed = False
        self.handlers: Dict[str, Any] = {}
        host.event_sources.append(self)

    def js_get_member(self, name: str):
        if name == "close":
            def close():
                self.closed = True
            return close
        if name == "url":
            return self.url
        return self.handlers.get(name, UNDEFINED)

    def js_set_member(self, name: str, value):
        self.handlers[name] = value

    def fire_message(self, data: str):
        """Test hook: deliver one SSE frame to onmessage."""
        fn = self.handlers.get("onmessage")
        if fn is not None:
            self.host.interp.invoke(fn, [Event(data=data)])

    def fire_error(self):
        fn = self.handlers.get("onerror")
        if fn is not None:
            self.host.interp.invoke(fn, [Event()])


class _Blob:
    def __init__(self, parts, opts=None):
        self.content = "".join(_to_text(p) for p in (parts or []))

    def js_get_member(self, name):
        if name == "size":
            return float(len(self.content))
        return UNDEFINED

    def js_set_member(self, name, value):
        raise AttributeError("blobs are read-only")


class _Date:
    def __init__(self, iso=None):
        if iso is None or iso is UNDEFINED:
            self.dt = _dt.datetime(2026, 1, 1)  # deterministic "now"
        else:
            text = _to_text(iso).replace("Z", "+00:00")
            try:
                self.dt = _dt.datetime.fromisoformat(text)
            except ValueError:
                self.dt = _dt.datetime(1970, 1, 1)

    def js_get_member(self, name):
        if name == "toLocaleTimeString":
            return lambda *a: self.dt.strftime("%H:%M:%S")
        if name == "toISOString":
            return lambda: self.dt.strftime("%Y-%m-%dT%H:%M:%S.000Z")
        if name == "getTime":
            return lambda: self.dt.timestamp() * 1000.0
        if name == "getHours":
            return lambda: float(self.dt.hour)
        return UNDEFINED

    def js_set_member(self, name, value):
        raise AttributeError("dates are read-only")


class _URL:
    def __init__(self, host: "DomHost"):
        self.host = host

    def js_get_member(self, name):
        if name == "createObjectURL":
            def create(blob):
                url = f"blob:{len(self.host.blobs)}"
                self.host.blobs[url] = getattr(blob, "content", "")
                return url
            return create
        if name == "revokeObjectURL":
            return lambda url: None
        return UNDEFINED

    def js_set_member(self, name, value):
        raise AttributeError("URL is read-only")


# ---------------------------------------------------------------------------
# The host
# ---------------------------------------------------------------------------

class DomHost:
    """Wires a parsed page + browser shims into a minijs interpreter.

    >>> host = DomHost(page_html, client)   # werkzeug-shaped client
    >>> host.run_scripts()                  # lib modules + inline glue
    >>> host.click("calc")                  # fire a recorded handler
    >>> host.by_id("c-dist").js_get_member("textContent")
    """

    def __init__(self, page_html: str, client,
                 rng=lambda: 0.5) -> None:
        self.client = client
        self.root = Element("html", self)
        _parse_fragment(_strip_head(page_html), self.root, self)
        self.interp = Interpreter(rng=rng)
        self.localStorage = _LocalStorage()
        self.event_sources: List[_EventSource] = []
        self.timers: List[dict] = []
        self.blobs: Dict[str, str] = {}
        self.downloads: List[dict] = []
        self.fetch_log: List[str] = []
        self._install()
        self.page_html = page_html

    # -- installation ----------------------------------------------------
    def _install(self):
        it = self.interp
        it.set_global("document", _Document(self))
        it.set_global("localStorage", self.localStorage)
        it.set_global("fetch", self._fetch)
        it.set_global("EventSource",
                      lambda url: _EventSource(self, _to_text(url)))
        it.set_global("Blob", _Blob)
        it.set_global("URL", _URL(self))
        it.set_global("Date", _Date)
        it.set_global("Option", self._option)
        it.set_global("setTimeout", self._set_timer(False))
        it.set_global("setInterval", self._set_timer(True))
        it.set_global("clearTimeout", lambda i: None)
        it.set_global("clearInterval", lambda i: None)

    def _option(self, text="", value=""):
        el = Element("option", self)
        el.append(_to_text(text))
        el.props["value"] = _to_text(value)
        return el

    def _set_timer(self, repeating: bool):
        def setter(fn, delay=0.0, *a):
            self.timers.append({"fn": fn, "delay": delay,
                                "repeating": repeating})
            return float(len(self.timers))
        return setter

    def _fetch(self, url, opts=None):
        url = _to_text(url)
        self.fetch_log.append(url)
        opts = opts if isinstance(opts, dict) else {}
        method = _to_text(opts.get("method", "GET")).upper()
        headers = opts.get("headers") or {}
        body = opts.get("body")
        kwargs: Dict[str, Any] = {"headers": dict(headers)}
        if body is not None and body is not UNDEFINED:
            kwargs["data"] = _to_text(body)
        try:
            r = self.client.open(url, method=method, **kwargs)
        except Exception as e:  # connection-level failure → rejection
            return JSPromise.rejected({"name": "TypeError",
                                       "message": f"fetch failed: {e}"})
        return JSPromise.fulfilled(
            _Response(r.status_code, r.get_data(),
                      r.headers.get("Content-Type", "")))

    # -- script execution ------------------------------------------------
    def run_scripts(self):
        """Execute the page's scripts in order: each ``<script src>``
        is fetched from the live client; inline blocks run as-is."""
        for src, inline in _page_scripts(self.page_html):
            if src:
                r = self.client.get(src)
                assert r.status_code == 200, f"missing script {src}"
                self.interp.run(r.get_data(as_text=True))
            else:
                self.interp.run(inline)

    # -- test conveniences -----------------------------------------------
    def by_id(self, el_id: str) -> Element:
        for el in self.root.walk():
            if el.attrs.get("id") == el_id:
                return el
        raise KeyError(el_id)

    def text(self, el_id: str) -> str:
        return self.by_id(el_id)._text()

    def click(self, el_id: str, event: Optional[Event] = None):
        """Invoke an element's recorded onclick; unwrap the promise."""
        return self._click(self.by_id(el_id), event)

    def _click(self, el: Element, event: Optional[Event] = None):
        if el.tag == "a":
            name = el.props.get("download", "")
            href = _to_text(el.props.get("href", ""))
            self.downloads.append(
                {"download": name, "href": href,
                 "content": self.blobs.get(href, "")})
            return UNDEFINED
        fn = el.props.get("onclick")
        if fn is None or fn is UNDEFINED:
            raise AssertionError(f"no onclick on {el!r}")
        out = self.interp.invoke(fn, [event or Event()])
        value = self.interp.await_value(out)
        # a handler's fire-and-forget async work must not fail silently
        self.interp.check_unhandled_rejections()
        return value


def _strip_head(page_html: str) -> str:
    """Body only: the <style>/<head> content isn't DOM under test, and
    <script> bodies must not be parsed as markup."""
    body = page_html
    if "<body>" in body:
        body = body.split("<body>", 1)[1]
    body = _re.sub(r"<script\b[^>]*>.*?</script>", "", body,
                   flags=_re.S)
    return body.split("</body>")[0]


def _page_scripts(page_html: str):
    """Yield (src, inline) for each <script> in document order."""
    for m in _re.finditer(
            r"<script\b([^>]*)>(.*?)</script>", page_html, _re.S):
        attrs, body = m.group(1), m.group(2)
        src = _re.search(r'src="([^"]+)"', attrs)
        yield (src.group(1) if src else None,
               None if src else body)
