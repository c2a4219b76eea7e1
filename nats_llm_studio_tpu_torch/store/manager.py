"""ModelStore: local GGUF cache + Object Store distribution.

Copy of ``nats_llm_studio_tpu/store/manager.py``: the same cache layout,
safe-name checks, split-shard set checks, staged commits, URL-scheme
allowlist and pull ceiling, so a cache or a bucket filled by either
package serves the other.

Reproduces the reference's on-disk contract — models live at
``<models_dir>/<publisher>/<model>/*.gguf`` (nats_llm_studio.go:120, README
default ``~/.lmstudio/models``) and bucket objects are named
``<publisher>/<model>/<file>.gguf`` (README.md:279-281). The reference's
delete-path duplication bug (publisher derived from an id that already
contains it, nats_llm_studio.go:111-120 — SURVEY.md §2.1) is consciously
fixed here: ids are always ``publisher/model`` and never re-prefixed.
"""

from __future__ import annotations

import asyncio
import os
import re
import shutil
from dataclasses import dataclass
from pathlib import Path

from ..gguf.reader import _SPLIT_RE
from ..transport.jetstream import ObjectNotFound, ObjectStore
from ..utils.nuid import next_nuid


def _tmp_part(dest_dir: Path, fname: str) -> Path:
    """Unique temp path per pull: concurrent pulls of the same target must
    not interleave writes into a shared .part file."""
    return dest_dir / f".{fname}.{os.getpid()}.{next_nuid()[:8]}.part"


def _shard_family(files: "list[Path]") -> "list[Path]":
    """The files that form ONE model: files[0]'s gguf-split family (every
    shard with the same base and total), or just files[0] for a plain file.
    Keeps publish from shipping unrelated .gguf files that share a dir."""
    first = files[0]
    m = _SPLIT_RE.match(first.name)
    if not m:
        return [first]
    base, total = m.group(1), m.group(3)
    fam = [
        f for f in files
        if (fm := _SPLIT_RE.match(f.name)) and fm.group(1) == base and fm.group(3) == total
    ]
    return sorted(fam)


def _check_split_complete(names: "list[str]") -> None:
    """Every split-named object's family must be complete — pulling a
    partial shard set would cache a model that cannot load."""
    have = set(names)
    for nm in names:
        m = _SPLIT_RE.match(Path(nm).name)
        if not m:
            continue
        base, total = m.group(1), int(m.group(3))
        prefix = nm.rsplit("/", 1)[0]
        for i in range(total):
            want = f"{prefix}/{base}-{i + 1:05d}-of-{total:05d}.gguf"
            if want not in have:
                raise StoreError(
                    f"incomplete split set in bucket: missing {want!r}"
                )


class StoreError(Exception):
    def __init__(self, msg: str, dir: str | None = None):
        super().__init__(msg)
        self.dir = dir


@dataclass
class CachedModel:
    model_id: str  # "publisher/model"
    publisher: str
    name: str
    path: Path  # directory
    files: list[Path]  # .gguf files inside

    @property
    def gguf_path(self) -> Path:
        return self.files[0]

    @property
    def size(self) -> int:
        return sum(f.stat().st_size for f in self.files)


# every path component a model id may contribute to the cache layout: must
# start alphanumeric (excludes '.', '..', hidden files), stay in a
# conservative charset (excludes separators, NUL, '~', '%'-escapes resolving
# later), and not END in '.' or ' ' — Windows strips those, so two distinct
# advertised ids would collide on one directory there. Trailing '_'/'-' are
# safe on every platform and stay allowed (ids cached by earlier releases
# must remain listable/deletable). Model ids are CLIENT-CONTROLLED
# (pull/delete/sync subjects), and model_dir()/delete_local() turn them into
# mkdir/rmtree targets.
_SAFE_COMPONENT = re.compile(r"[A-Za-z0-9](?:[A-Za-z0-9._\- ]*[A-Za-z0-9_\-])?\Z")
# lenient variant for dirs that ALREADY exist in the cache (written by an
# earlier release whose pattern allowed trailing '.'): same conservative
# charset — no traversal, no separators — so listing/deleting them stays
# safe ON POSIX; only CREATION is held to the strict pattern. Without this
# a legacy 'pub/llama3.' dir could never be reclaimed over the bus.
# Trailing SPACE stays excluded even here: split_model_id's whole-id strip
# collapses 'pub/llama3 ' to 'pub/llama3', so a trailing-space id can only
# ever alias its sibling (rmtree the WRONG model) — those dirs were never
# addressable over the bus and must not be advertised. On Windows the
# lenient mode is DISABLED: the filesystem strips trailing '.' on access,
# so 'pub/llama3.' would alias the distinct strict-valid 'pub/llama3' —
# and legacy trailing-dot dirs cannot exist there anyway (uncreatable).
_SAFE_COMPONENT_LEGACY = re.compile(r"[A-Za-z0-9](?:[A-Za-z0-9._\- ]*[A-Za-z0-9._\-])?\Z")


def split_model_id(model_id: str, strict: bool = True) -> tuple[str, str]:
    """"publisher/model" -> (publisher, model); bare names get publisher
    "local" (mirrors the reference's fallback of deriving the publisher from
    the id prefix, nats_llm_studio.go:112-118, without the duplication).

    Every '/'-separated component is validated against a conservative
    pattern: a hostile id like '../../../etc' must never become a
    filesystem path (model_dir -> mkdir; delete_local -> rmtree).
    ``strict=False`` (lookup/list/delete of dirs that already exist) accepts
    the legacy charset on POSIX so caches written by earlier releases stay
    reachable; creation paths — and everything on Windows, where trailing
    '.'/' ' alias other dirs — always use the strict pattern."""
    model_id = model_id.strip().strip("/")
    lenient = not strict and os.name != "nt"
    pattern = _SAFE_COMPONENT_LEGACY if lenient else _SAFE_COMPONENT
    for comp in model_id.split("/"):
        if not pattern.match(comp):
            raise StoreError(f"unsafe model id component {comp!r} in {model_id!r}")
    if "/" in model_id:
        pub, _, name = model_id.partition("/")
        return pub, name
    return "local", model_id


class ModelStore:
    """Local cache directory + optional Object Store bucket."""

    def __init__(self, models_dir: str | Path, objstore: ObjectStore | None = None,
                 bucket: str = "llm-models",
                 url_schemes: tuple[str, ...] = ("https", "http", "file"),
                 max_url_pull_bytes: int = 100 << 30):
        self.models_dir = Path(models_dir).expanduser()
        self.models_dir.mkdir(parents=True, exist_ok=True)
        self.objstore = objstore
        self.bucket = bucket
        # which URL schemes pull() may fetch. Library default is permissive;
        # SERVING processes pass the config's (https-only by default) — a
        # shared-bus client must not be able to drive the worker to GET
        # internal endpoints or read local files into the served cache (SSRF)
        self.url_schemes = tuple(url_schemes)
        # ceiling on a single URL pull: a hostile/huge URL must not fill the
        # worker's disk (default matches the reference's 100 GiB JetStream
        # file-store bound, setup_unix.sh:93)
        self.max_url_pull_bytes = max_url_pull_bytes

    # -- local cache ---------------------------------------------------------

    def model_dir(self, model_id: str, strict: bool = True) -> Path:
        pub, name = split_model_id(model_id, strict=strict)
        return self.models_dir / pub / name

    def cached(self) -> list[CachedModel]:
        out = []
        for pub_dir in sorted(p for p in self.models_dir.iterdir() if p.is_dir()):
            for model_dir in sorted(p for p in pub_dir.iterdir() if p.is_dir()):
                # only list ids that round-trip through split_model_id's
                # lenient validation — a hand-placed dir with an unsafe name
                # would otherwise be advertised but impossible to load or
                # delete over the bus (lookup/delete would raise). The
                # LEGACY pattern here keeps caches from earlier releases
                # (trailing '.'/' ') listable and reclaimable.
                if not (_SAFE_COMPONENT_LEGACY.match(pub_dir.name)
                        and _SAFE_COMPONENT_LEGACY.match(model_dir.name)):
                    continue
                files = sorted(model_dir.glob("*.gguf"))
                if files:
                    out.append(
                        CachedModel(
                            model_id=f"{pub_dir.name}/{model_dir.name}",
                            publisher=pub_dir.name,
                            name=model_dir.name,
                            path=model_dir,
                            files=files,
                        )
                    )
        return out

    def lookup(self, model_id: str) -> CachedModel | None:
        d = self.model_dir(model_id, strict=False)
        files = sorted(d.glob("*.gguf")) if d.is_dir() else []
        if not files:
            return None
        pub, name = split_model_id(model_id, strict=False)
        return CachedModel(f"{pub}/{name}", pub, name, d, files)

    def delete_local(self, model_id: str) -> str:
        """Remove the model directory; returns the deleted dir (the
        reference replies ``deleted_dir``, nats_llm_studio.go:316-323).
        Lenient validation: legacy-named dirs must stay deletable."""
        d = self.model_dir(model_id, strict=False)
        if not d.is_dir():
            raise StoreError(f"model directory not found: {d}", dir=str(d))
        shutil.rmtree(d)
        # drop the publisher dir too if now empty (keep models_dir tidy)
        try:
            d.parent.rmdir()
        except OSError:
            pass
        return str(d)

    def import_file(self, src: str | Path, model_id: str) -> Path:
        """Copy a local .gguf into the cache layout (the `lms import` analog,
        upstream README.md:316)."""
        src = Path(src)
        dest_dir = self.model_dir(model_id)
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / src.name
        shutil.copyfile(src, dest)
        return dest

    # -- object store --------------------------------------------------------

    def _require_store(self) -> ObjectStore:
        if self.objstore is None:
            raise StoreError("object store not configured")
        return self.objstore

    async def publish_model(self, model_id: str, gguf_path: str | Path | None = None) -> str:
        """Upload a cached model (or explicit file) to the bucket as
        ``<publisher>/<model>/<file>.gguf``. A model cached as a gguf-split
        shard set uploads EVERY shard (a worker pulling the model needs the
        complete set to load it). Returns the first object name."""
        store = self._require_store()
        if gguf_path is None:
            cm = self.lookup(model_id)
            if cm is None:
                raise StoreError(f"model {model_id!r} not in local cache")
            paths = _shard_family(cm.files)
        else:
            paths = [Path(gguf_path)]
        pub, name = split_model_id(model_id)
        await store.ensure_bucket(self.bucket)
        obj_names = []
        for p in paths:
            obj_name = f"{pub}/{name}/{p.name}"
            data = await asyncio.to_thread(p.read_bytes)  # keep the loop serving
            await store.put(self.bucket, obj_name, data)
            obj_names.append(obj_name)
        return obj_names[0]

    async def pull(self, identifier: str, model_id: str | None = None) -> tuple[Path, str]:
        """Fetch a model from the bucket into the local cache (the `lms get`
        replacement, nats_llm_studio.go:46-59; conceptual sync flow
        README.md:286-318). ``identifier`` is an object name
        ``publisher/model/file.gguf``, a model id ``publisher/model``, or an
        ``http(s)://`` / ``file://`` URL to a GGUF (the catalog-download
        capability `lms get` has for public models); ``model_id`` overrides
        the cache location (README.md:306 lets the sync flow choose the
        local model dir). Returns (local_path, transcript)."""
        if identifier.startswith(("http://", "https://", "file://")):
            scheme = identifier.split("://", 1)[0]
            if scheme not in self.url_schemes:
                raise StoreError(
                    f"URL pulls via {scheme!r} are not allowed on this worker"
                )
            return await self._pull_url(identifier, model_id)
        store = self._require_store()
        lines = [f"pulling {identifier!r} from bucket {self.bucket!r}"]
        obj_name = identifier.strip().strip("/")
        if not obj_name.endswith(".gguf"):
            # model id: pull EVERY object under the prefix (a split model is
            # several shard objects; one shard alone cannot be loaded)
            objs = await store.list(self.bucket)
            matches = sorted(
                o.name for o in objs if o.name.startswith(obj_name + "/")
            )
            if not matches:
                raise StoreError(f"no objects under {obj_name!r} in bucket {self.bucket!r}")
            _check_split_complete(matches)
            lines.append(f"resolved to {len(matches)} object(s)")
            # stage every shard, commit only when the whole set landed —
            # the single-file temp/rename atomicity must hold for the SET
            # (a partial set would look cached but fail to load)
            staged: list[tuple[Path, Path, int]] = []
            try:
                for nm in matches:
                    staged.append(await self._pull_object(nm, model_id))
            except BaseException:
                for _, tmp, _ in staged:
                    tmp.unlink(missing_ok=True)
                raise
            for dest, tmp, total in staged:
                tmp.replace(dest)
                lines.append(f"wrote {total} bytes to {dest}")
            return staged[0][0], "\n".join(lines)
        dest, tmp, total = await self._pull_object(obj_name, model_id)
        tmp.replace(dest)
        lines.append(f"wrote {total} bytes to {dest}")
        return dest, "\n".join(lines)

    async def _pull_object(
        self, obj_name: str, model_id: str | None
    ) -> tuple[Path, Path, int]:
        """Stream one bucket object to a staging file; returns
        (dest, tmp, bytes) — the caller commits with tmp.replace(dest)."""
        store = self._require_store()
        parts = obj_name.split("/")
        if len(parts) < 3:
            raise StoreError(
                f"object name {obj_name!r} must be <publisher>/<model>/<file>.gguf"
            )
        fname = parts[-1]
        # object names are CLIENT-CONTROLLED (any bus client can `nats obj
        # put` arbitrary names and then ask a worker to pull them): every
        # component that becomes a filesystem path must pass the strict
        # creation pattern, or 'a/../../x/f.gguf' would mkdir/write outside
        # models_dir
        for comp in parts:
            if not _SAFE_COMPONENT.match(comp):
                raise StoreError(
                    f"unsafe object name component {comp!r} in {obj_name!r}"
                )
        if model_id:
            dest_dir = self.model_dir(model_id)
        else:
            dest_dir = self.models_dir / parts[0] / "/".join(parts[1:-1])
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / fname
        # stream chunk-at-a-time into a temp file: peak RAM is O(chunk), not
        # O(object) — a 40 GB GGUF must not be materialized;
        # the rename commits only after size+digest verify in get_chunks
        tmp = _tmp_part(dest_dir, fname)
        total = 0
        try:
            with open(tmp, "wb") as f:
                async for chunk in store.get_chunks(self.bucket, obj_name):
                    total += len(chunk)
                    # buffered ~128 KB writes are ~us-cheap; a to_thread hop
                    # per chunk would cost more than the write itself. Yield
                    # periodically so a multi-GB pull cannot starve the loop.
                    f.write(chunk)
                    if total % (64 << 20) < len(chunk):
                        await asyncio.sleep(0)
        except ObjectNotFound as e:
            tmp.unlink(missing_ok=True)
            raise StoreError(f"object {obj_name!r} not found: {e}") from None
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        return dest, tmp, total

    async def _pull_url(self, url: str, model_id: str | None) -> tuple[Path, str]:
        """Stream a GGUF from an HTTP(S)/file URL into the local cache —
        restores the reference's `lms get <any catalog model>` capability
        (nats_llm_studio.go:46-59) without the LM Studio catalog."""
        import urllib.parse
        import urllib.request

        fname = Path(urllib.parse.urlparse(url).path).name or "model.gguf"
        if not fname.endswith(".gguf"):
            raise StoreError(f"URL pull expects a .gguf file, got {fname!r}")
        # the URL basename becomes a path component of the cache layout: a
        # stem like '..' or one with separators/odd bytes would escape the
        # publisher/model directory scheme
        stem = fname.removesuffix(".gguf")
        if not re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]*", stem) or ".." in stem:
            raise StoreError(f"unsafe model filename in URL: {fname!r}")
        mid = model_id or f"downloads/{stem}"
        dest_dir = self.model_dir(mid)
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / fname
        tmp = _tmp_part(dest_dir, fname)

        allowed = self.url_schemes

        class _SchemeGuardRedirect(urllib.request.HTTPRedirectHandler):
            # urlopen follows cross-scheme redirects; without this a
            # https-only allowlist could still be driven to http://
            # internal endpoints via a 302 (the SSRF the gate exists for)
            def redirect_request(self, req, fp, code, msg, headers, newurl):
                scheme = urllib.parse.urlparse(newurl).scheme
                if scheme not in allowed:
                    raise OSError(
                        f"redirect to disallowed scheme {scheme!r}: {newurl}"
                    )
                return super().redirect_request(req, fp, code, msg, headers, newurl)

        opener = urllib.request.build_opener(_SchemeGuardRedirect())

        limit = self.max_url_pull_bytes

        def fetch() -> int:
            total = 0
            with opener.open(url, timeout=60.0) as r, open(tmp, "wb") as f:
                expect = r.headers.get("Content-Length")
                if expect is not None and int(expect) > limit:
                    raise OSError(
                        f"download of {expect} bytes exceeds the "
                        f"{limit}-byte URL pull ceiling"
                    )
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    total += len(chunk)
                    if total > limit:
                        raise OSError(
                            f"download exceeded the {limit}-byte URL pull ceiling"
                        )
            # a premature close makes read() return b'' without an error —
            # verify against the advertised size before committing
            if expect is not None and total != int(expect):
                raise OSError(f"truncated download: got {total} of {expect} bytes")
            return total

        try:
            total = await asyncio.to_thread(fetch)
        except BaseException as e:
            tmp.unlink(missing_ok=True)
            if isinstance(e, (OSError, ValueError)):
                raise StoreError(f"download failed for {url!r}: {e}") from None
            raise
        tmp.replace(dest)
        return dest, f"downloaded {url!r}\nwrote {total} bytes to {dest}"
