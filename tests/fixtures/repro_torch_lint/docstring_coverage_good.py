"""Known-good audited module, fully documented (DESIGN.md §5)."""


class ServeEngine:
    """A documented public class."""

    def submit(self, req):
        """A documented public method."""
        return req

    async def serve(self, reqs):
        """A documented public coroutine."""
        return reqs

    def _admit(self, req):
        return req  # private slots are out of scope


def make_engine(cfg):
    """A documented public function."""
    return ServeEngine()
