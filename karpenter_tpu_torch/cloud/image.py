"""Image resolver: by-ID, by-name, and semantic selector resolution.

Parity with ``pkg/providers/common/image/resolver.go``: direct id/name
lookup (:49-126) and semantic selection — parse ``os-major-minor-arch
[-variant]`` image names, filter by selector fields, pick the newest
(:134-432).

(Copy of ``karpenter_tpu/cloud/image.py``.)
"""

from __future__ import annotations

import re

from karpenter_tpu_torch.apis.nodeclass import ImageSelector
from karpenter_tpu_torch.cloud.errors import not_found
from karpenter_tpu_torch.cloud.fake import FakeImage

_NAME_RE = re.compile(
    r"^(?P<os>[a-z]+)-(?P<major>\d+)(?:-(?P<minor>\d+))?-(?P<arch>amd64|arm64|s390x)"
    r"(?:-(?P<variant>[a-z0-9]+))?$")


def parse_image_name(name: str):
    m = _NAME_RE.match(name)
    if not m:
        return None
    return m.groupdict()


class ImageResolver:
    def __init__(self, client):
        self._client = client

    def resolve(self, image: str = "", selector: ImageSelector | None = None) -> str:
        """-> image id."""
        if image:
            return self._resolve_direct(image)
        if selector is not None:
            return self._resolve_selector(selector)
        raise ValueError("image or image selector required")

    def _resolve_direct(self, image: str) -> str:
        images = self._client.list_images()
        for img in images:
            if img.id == image:
                return img.id
        for img in images:
            if img.name == image:
                return img.id
        raise not_found("image", image)

    def _resolve_selector(self, sel: ImageSelector) -> str:
        candidates: list[FakeImage] = []
        for img in self._client.list_images():
            if img.status != "available":
                continue
            parsed = parse_image_name(img.name)
            if parsed is None:
                continue
            if sel.os and parsed["os"] != sel.os:
                continue
            if sel.major_version and parsed["major"] != sel.major_version:
                continue
            if sel.minor_version and (parsed["minor"] or "") != sel.minor_version:
                continue
            if sel.architecture and parsed["arch"] != sel.architecture:
                continue
            if sel.variant and (parsed["variant"] or "") != sel.variant:
                continue
            candidates.append(img)
        if not candidates:
            raise not_found(
                "image matching selector",
                f"{sel.os}-{sel.major_version}-{sel.minor_version}-{sel.architecture}")
        # newest first: by (major, minor) then creation time (:134-432)
        def version_key(img: FakeImage):
            p = parse_image_name(img.name)
            return (int(p["major"]), int(p["minor"] or 0), img.created_at)
        return max(candidates, key=version_key).id
