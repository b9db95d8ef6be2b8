"""Per-request context: dial url + api key + streamed choice + limits."""

from dataclasses import dataclass

from dial_rag_tpu_torch.runtime.limited import DialLimitedResources
from dial_rag_tpu_torch.service.protocol import Choice


@dataclass
class RequestContext:
    dial_url: str
    api_key: str
    choice: Choice
    dial_limited_resources: DialLimitedResources

    def is_dial_url(self, url: str) -> bool:
        return url.startswith(self.dial_url)

    @property
    def dial_base_url(self) -> str:
        return f"{self.dial_url}/v1/"

    @property
    def dial_metadata_base_url(self) -> str:
        return f"{self.dial_base_url}metadata/"

    def get_file_access_headers(self, url: str) -> dict:
        if not self.is_dial_url(url):
            return {}
        return self.get_api_key_headers()

    def get_api_key_headers(self) -> dict:
        return {"api-key": self.api_key}
