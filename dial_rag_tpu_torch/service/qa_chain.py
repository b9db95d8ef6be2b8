"""Answer generation: context prompt assembly, streamed LLM call, and
streamed citation rewriting (mirror of reference qa_chain.py)."""

from datetime import date
from typing import AsyncIterator, Callable

from dial_rag_tpu_torch.errors import DialRagError
from dial_rag_tpu_torch.index.records import SearchHit
from dial_rag_tpu_torch.service.api import RetrievalResponse
from dial_rag_tpu_torch.service.citations import rewrite_citations
from dial_rag_tpu_torch.service.config import ChatChainConfig
from dial_rag_tpu_torch.service.llm import LlmClient
from dial_rag_tpu_torch.service.request_context import RequestContext

# PROVENANCE: this system prompt is intentionally pinned verbatim to the
# reference's (reference qa_chain.py:28-44). The prompt IS the product
# behavior — the citation notation it demands is what rewrite_citations
# parses, the `<doc id= page_number= source=>` wire format below is a
# golden-tested contract, and recorded LLM replay caches key on the
# exact prompt bytes. Do not "improve" the wording without versioning
# the replay caches.
DEFAULT_SYSTEM_TEMPLATE = """You are helpful assistant. You are to answer the user questions based on user provided documents.
User can attach the documents to the conversation by using the paperclip button.
The attachments are already processed by the system and the relevant pieces of the documents are available in the context.
The pdf, doc, ppt and text files are supported for the attachments.
Use the following pieces of context from user documents and the images of the pages from user documents to answer the users question.
If you don't know the answer, just say that you don't know, don't try to make up an answer.

Current date is _date_.

Anything between the 'context' xml blocks is retrieved from a knowledge bank, not part of the conversation with the user.

Cite pieces of context using <[number]> notation (like <[2]>). Only cite the most relevant pieces of context that answer the question accurately.
Place these citations at the end of the sentence or paragraph that reference them - do not put them all at the end.
If different citations refer to different entities within the same name, write separate answers for each entity.
If you want to cite multiple pieces of context for the same sentence, format it as `<[number1]> <[number2]>`.
However, you should NEVER do this with the same number - if you want to cite `number1` multiple times for a sentence, only do `<[number1]>` not `<[number1]> <[number1]>`.
"""


def format_attributes(
    id: int, page_number: int | None, source_url: str | None
) -> str:
    attributes = [("id", str(id))]
    if page_number is not None:
        attributes.append(("page_number", str(page_number)))
    if source_url:
        attributes.append(("source", source_url))
    return " ".join(f"{k}='{v}'" for k, v in attributes)


def text_element(text: str) -> dict:
    return {"type": "text", "text": text}


def image_element(image: str) -> dict:
    return {
        "type": "image_url",
        "image_url": {"url": f"data:image/png;base64,{image}"},
    }


def create_docs_message(retrieval_response: RetrievalResponse) -> list[dict]:
    """Chunks + page images rendered as <context><doc ...> blocks
    (reference qa_chain.py:80-100)."""
    docs_message = [text_element("<context>")]
    for i, chunk in enumerate(retrieval_response.chunks, start=1):
        attributes = format_attributes(
            id=i,
            page_number=chunk.page.number if chunk.page else None,
            source_url=chunk.source.url,
        )
        docs_message.append(
            text_element(f"<doc {attributes}>\n{chunk.text}\n")
        )
        if chunk.page is not None and chunk.page.image_index is not None:
            image = retrieval_response.images[chunk.page.image_index]
            docs_message.append(image_element(image.data))
        docs_message.append(text_element("</doc>\n"))
    docs_message.append(text_element("</context>"))
    return docs_message


def create_chat_prompt(
    config: ChatChainConfig,
    chat_history: list[dict],
    query: str,
    retrieval_response: RetrievalResponse,
) -> list[dict]:
    system_template = (
        config.system_prompt_template_override or DEFAULT_SYSTEM_TEMPLATE
    )
    system = system_template.replace("_date_", date.today().isoformat())

    if config.use_history and chat_history:
        prompt = [{"role": "system", "content": system}] + [
            dict(m) for m in chat_history
        ]
    else:
        prompt = [
            {"role": "system", "content": system},
            {"role": "user", "content": query},
        ]

    # merge the retrieved context into the last (user) message
    last = prompt[-1]
    if last["role"] != "user":
        # a conversation must end with the user's turn (reference
        # qa_chain builds the same shape); reject instead of silently
        # relabeling an assistant message
        error = DialRagError("The last message must be a user message")
        error.status_code = 400
        raise error
    content = last["content"]
    parts = [text_element(content)] if isinstance(content, str) else list(content)
    parts.extend(create_docs_message(retrieval_response))
    prompt[-1] = {"role": "user", "content": parts}
    return prompt


async def generate_answer(
    request_context: RequestContext,
    chat_chain_config: ChatChainConfig,
    chat_history: list[dict],
    query: str,
    found_items: list[SearchHit],
    retrieval_response: RetrievalResponse,
    content_callback: Callable[[str], None],
) -> list[SearchHit]:
    """Stream the answer with rewritten citations; return the cited hits
    in first-use order (reference qa_chain.py:198-218)."""
    llm = LlmClient(
        request_context.dial_url,
        request_context.api_key,
        chat_chain_config.llm,
    )
    prompt = create_chat_prompt(
        chat_chain_config, chat_history, query, retrieval_response
    )

    async def answer_stream() -> AsyncIterator[str]:
        async for piece in llm.astream(prompt):
            yield piece

    reference_items: list[SearchHit] = []
    async for piece, used in rewrite_citations(
        answer_stream(), len(found_items)
    ):
        if used is not None:
            reference_items = [found_items[i] for i in used]
        elif piece:
            content_callback(piece)
    return reference_items
