"""Known-bad serving module: the port's device syncs inside async def."""
import torch


class AsyncServer:
    async def serve(self, reqs):
        out = await self._dispatch(reqs)
        torch.cuda.synchronize()  # waits for the card on the loop
        self.done.synchronize()  # an event's sync on the loop
        torch.cuda.current_stream().synchronize()  # a stream's sync
        return out
