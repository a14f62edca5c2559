"""Known-bad serving module: blocking calls inside async def."""
import time


class AsyncServer:
    async def serve(self, reqs):
        time.sleep(0.01)  # blocks the event loop
        out = self.engine.run(reqs)  # enumeration on the loop
        out.arr.block_until_ready()  # device sync on the loop
        return out
