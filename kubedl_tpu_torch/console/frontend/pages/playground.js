// Inference playground (beyond-parity: the reference console has no
// serving surface): pick a deployed Inference, chat with it through the
// console's predictor proxy (/api/v1/inference/predict -> the
// predictor's OpenAI-convention routes).
import { api, esc, t } from "../app.js";

const history = [];   // [{role, content}] of the current conversation

export async function viewPlayground(app) {
  const infs = await api("/inference/list");
  app.innerHTML = `
    <div class="panel"><h2>${esc(t("playground.title"))}</h2>
      ${infs.length ? "" : `<p class="muted">${esc(t("playground.none"))}</p>`}
      <div class="kv">
        <span class="muted">${esc(t("playground.target"))}</span>
        <select id="pg-target">${infs.map(i =>
          `<option value="${esc(i.namespace)}/${esc(i.name)}">
             ${esc(i.namespace)}/${esc(i.name)} (${esc(i.framework)})
           </option>`).join("")}</select>
        <span class="muted">${esc(t("playground.maxTokens"))}</span>
        <input id="pg-max" type="number" value="256" min="1">
        <span class="muted">${esc(t("playground.temperature"))}</span>
        <input id="pg-temp" type="number" value="0" min="0" step="0.1">
        <span class="muted">${esc(t("playground.stopSeq"))}</span>
        <input id="pg-stopseq" type="text"
          placeholder="${esc(t("playground.stopHint"))}">
      </div>
      <div id="pg-chat" class="chat"></div>
      <form id="pg-form">
        <textarea id="pg-input" rows="3"
          placeholder="${esc(t("playground.placeholder"))}"></textarea>
        <div>
          <button type="submit">${esc(t("playground.send"))}</button>
          <button type="button" id="pg-stop" class="ghost" hidden>
            ${esc(t("playground.stop"))}</button>
          <button type="button" id="pg-clear" class="ghost">
            ${esc(t("playground.clear"))}</button>
        </div>
      </form>
    </div>`;

  const chat = document.getElementById("pg-chat");
  const render = () => {
    chat.innerHTML = history.map(msg =>
      `<div class="msg ${esc(msg.role)}">
         <span class="muted">${esc(msg.role)}</span>
         <div>${esc(msg.content)}</div></div>`).join("");
    chat.scrollTop = chat.scrollHeight;
  };
  render();

  document.getElementById("pg-clear").onclick = () => {
    history.length = 0;
    render();
  };
  document.getElementById("pg-form").onsubmit = async e => {
    e.preventDefault();
    const input = document.getElementById("pg-input");
    const text = input.value.trim();
    if (!text) return;
    const [namespace, name] =
      document.getElementById("pg-target").value.split("/");
    history.push({ role: "user", content: text });
    input.value = "";
    // stream tokens into a live assistant message (SSE pass-through:
    // /api/v1/inference/stream -> the predictor's OpenAI chunk events)
    const reply = { role: "assistant", content: "" };
    history.push(reply);
    render();
    // Stop aborts the fetch; the console proxy drops its upstream
    // connection and the predictor cancels the lane (no tokens decoded
    // into the void)
    const abort = new AbortController();
    const stopBtn = document.getElementById("pg-stop");
    const sendBtn = e.target.querySelector("button[type=submit]");
    sendBtn.disabled = true;       // one in-flight stream at a time
    stopBtn.hidden = false;
    stopBtn.onclick = () => abort.abort();
    try {
      const res = await fetch("/api/v1/inference/stream", {
        method: "POST",
        signal: abort.signal,
        headers: { "Content-Type": "application/json" },
        body: JSON.stringify({
          namespace, name, messages: history.slice(0, -1),
          max_tokens: +document.getElementById("pg-max").value || 256,
          temperature: +document.getElementById("pg-temp").value || 0,
          ...(document.getElementById("pg-stopseq").value.trim()
            ? { stop: document.getElementById("pg-stopseq").value
                  .split(",").map(s => s.trim()).filter(Boolean) }
            : {}),
        }),
      });
      if (!res.ok) {
        const err = await res.json().catch(() => ({}));
        throw new Error(err.msg || `HTTP ${res.status}`);
      }
      const reader = res.body.getReader();
      const dec = new TextDecoder();
      let buf = "";
      for (;;) {
        const { done, value } = await reader.read();
        if (done) break;
        buf += dec.decode(value, { stream: true });
        let nl;
        while ((nl = buf.indexOf("\n")) >= 0) {
          const line = buf.slice(0, nl).trim();
          buf = buf.slice(nl + 1);
          if (!line.startsWith("data: ") || line === "data: [DONE]") continue;
          const chunk = JSON.parse(line.slice(6));
          const delta = chunk.choices?.[0]?.delta?.content
            ?? chunk.choices?.[0]?.text ?? "";
          if (delta) {
            reply.content += delta;
            render();
          }
        }
      }
    } catch (err) {
      if (err.name !== "AbortError") {
        reply.content += `[error] ${err.message}`;
        render();
      }
    } finally {
      stopBtn.hidden = true;
      sendBtn.disabled = false;
    }
  };
}
