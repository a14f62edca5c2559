"""Known-bad audited module: public slots undocumented, no section
anchor."""


class ServeEngine:
    def submit(self, req):
        return req

    async def serve(self, reqs):
        return reqs


def make_engine(cfg):
    return ServeEngine()
